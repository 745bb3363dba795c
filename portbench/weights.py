"""Weights drawn from the seed, on the device, in the type they are
served in.

Every normal leaf is carved out of one buffer that a single
``normal_`` call fills from a ``torch.Generator`` on the device; a
second generator (seed + 1) fills the LoRA adapters the same way. The
same seed gives the same weights on the same device, so the reference
draws them again after the program's state is freed. Scales follow the
usual initialisation of these models: N(0, 0.02) for every projection,
0.02 / sqrt(2 L) for the projections that write the residual stream,
ones for the norm gains. ``b`` of an adapter is drawn too (not zero),
so that both adapter gradients carry signal from the first step.
"""

from __future__ import annotations

import math

import torch

from portbench.arch import Arch, param_shapes

RESIDUAL_WRITERS = ("wo", "w_down", "moe_down")
STD = 0.02


def _std(a: Arch, path: str) -> float | None:
    name = path.rsplit("/", 1)[-1]
    if "norm" in name:
        return None
    if name in RESIDUAL_WRITERS:
        return STD / math.sqrt(2.0 * a.layers)
    return STD


def _fill(shapes: dict, a: Arch, seed: int, dtype, device) -> dict:
    """``{path: tensor}``: the normal leaves as views of one buffer filled
    by one draw, then scaled leaf by leaf; norm gains are ones."""
    normal = {p: s for p, s in shapes.items() if _std(a, p) is not None}
    sizes = [math.prod(s) for s in normal.values()]
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf.normal_(0.0, 1.0, generator=gen)
    out, off = {}, 0
    for (path, shape), n in zip(normal.items(), sizes):
        out[path] = buf[off:off + n].view(shape).mul_(_std(a, path))
        off += n
    for path, shape in shapes.items():
        if path not in out:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
    return {p: out[p] for p in shapes}


def nest(flat: dict) -> dict:
    """``{"blocks/wq": t}`` -> ``{"blocks": {"wq": t}}``."""
    tree: dict = {}
    for path, t in flat.items():
        *head, leaf = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def draw(a: Arch, seed: int, device, *, lora_rank: int = 0,
         lora_targets: tuple = ()) -> dict:
    """The flat ``{path: tensor}`` weights of ``a`` (and its adapters) for
    ``seed``, in the configuration's dtype."""
    dtype = getattr(torch, a.dtype)
    base = param_shapes(a)
    out = _fill(base, a, 2 * seed, dtype, device)
    if lora_rank:
        adapters = {p: s for p, s in param_shapes(
            a, lora_rank, lora_targets).items() if p not in base}
        out.update(_fill(adapters, a, 2 * seed + 1, dtype, device))
    return out
