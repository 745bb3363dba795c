"""``prefix_hit_ratio.serve``: the share of the prompt tokens admitted
during the window that the engine's prefix cache served, from its own
counters (``prefix_hit_tokens`` over ``prompt_tokens``), in percent."""


def read(r: dict):
    n = r.get("prompt_tokens")
    return 100.0 * r["prefix_hits"] / n if n else None
