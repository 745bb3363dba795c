"""``decode_step_ms.serve``: the median wall time of the window's engine
steps that admitted nothing (no prefill ran in them), untraced steps
only. ``step`` waits for the card when it samples, so each is one
decode step end to end."""

import statistics


def read(r: dict):
    walls = r.get("decode_step_s")
    return 1e3 * statistics.median(walls) if walls else None
