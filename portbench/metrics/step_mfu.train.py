"""``step_mfu.train``: the window's model FLOPs a second over the card's
dense bf16 peak, in percent. Model FLOPs are ``portbench.flops``'s count
of every step that finished in the window (frozen base at 4 a matmul
parameter, adapters at 6, same-document attention pairs, no remat)."""

from portbench.flops import PEAK_FLOPS


def read(r: dict):
    if not r.get("model_flops") or r.get("window_s", 0) <= 0:
        return None
    return 100.0 * r["model_flops"] / r["window_s"] / PEAK_FLOPS
