"""``flash_roofline.train``: the three flash kernels' share of their
roofline over the traced steps, in percent: the sum of every launch's
bound (``portbench.flops.flash_launch`` on that step's own document
layout) over the sum of the launches' device time. One launch covers one
attention call (every B·H of these cells fits one grid)."""

from portbench import flops

KERNELS = {"fwd": "flash_fwd_kernel", "dq": "flash_bwd_dq_kernel",
           "dkv": "flash_bwd_dkv_kernel"}


def read(r: dict):
    t, rows = r.get("trace"), r.get("flash_rows")
    if t is None or not rows:
        return None
    bound = device = 0.0
    for kind, name in KERNELS.items():
        secs, n = t.kernel(name)
        if n == 0:
            continue
        per = sum(flops.flash_launch(kind, r["arch"], x)["bound_s"]
                  for x in rows) / len(rows)
        bound += per * n
        device += secs
    return 100.0 * bound / device if device > 0 else None
