"""Flash attention, forward and backward (counterpart of
``kubeflow_rm_tpu/ops/flash_attention.py``).

Four layers, all computing one function and its gradient:

- ``flash_attention`` — the public op in the ``dot_product_attention``
  layout: q (B, T, H, D), k/v (B, T, KVH, D) -> (B, T, H, D).
  ``flash_attention_with_lse`` also returns the softmax residual
  ``lse`` (B, H, T) (not differentiable).
- ``torch.ops.kfrm.flash_attention`` — one autograd node (a
  ``torch.library`` custom op, so the profiler and selective
  checkpointing see it as one op) in the kernels' layout. Its forward
  saves ``(q, k, v, segq, segkv, out, lse)``, as JAX's
  ``_flash_fwd_rule`` does; its backward is
  ``torch.ops.kfrm.flash_attention_bwd``. The CPU takes the same node.
- ``flash_fwd`` / ``flash_bwd`` — the wrappers of the Hopper kernels
  (``kernels/csrc/flash_fwd.cu``, ``kernels/csrc/flash_bwd.cu``) in the
  kernels' own layout: q (B·H, T, D), k/v (B·KVH, T, D), bf16,
  contiguous. On a CUDA tensor each launches its kernel (and counts the
  launch in ``flash_fwd.launches``, ``flash_bwd_dq.launches``,
  ``flash_bwd_dkv.launches``) or raises; none falls back.
- ``flash_attention_reference`` / ``flash_attention_reference_bh`` /
  ``flash_attention_bwd_reference`` — the plain PyTorch versions. The
  node runs them for a tensor on the CPU; on the card they are what the
  kernels are held against.

Semantics (the TPU kernels'): causal over LOCAL indices, ANDed with
segment-id equality. For the packed-documents layout (positions restart
per document and rise within it) local-causal ∧ same-segment equals
position-causal ∧ same-segment. A row that matches no key gives
``O = 0``, ``lse = NEG_INF`` and ``dQ = 0``, and adds nothing to dK/dV.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from kubeflow_rm_tpu_torch.ops.attention import NEG_INF

#: head dims the kernel is instantiated for (every Llama preset has 128)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16,)
#: rows (of B·H, or of B·KVH for dK/dV) one launch may take: the kernels
#: put them on grid y, and their C entry points refuse more
GRID_ROWS_MAX = 65535


def row_chunks(BH: int, heads: int,
               limit: int = GRID_ROWS_MAX) -> list[tuple[int, int]]:
    """The q-row ranges ``[start, stop)`` the wrappers launch one by one:
    in order, covering each of the ``BH`` rows once, each cut at a
    multiple of ``heads`` (whole batch rows, so the segment-id rows and
    the GQA kv row ``bh // group`` stay whole) and at most ``limit``
    rows. One range when ``BH <= limit``."""
    per = limit // heads * heads
    if per == 0:
        raise ValueError(f"{heads} heads exceed the kernels' {limit} rows")
    return [(r, min(r + per, BH)) for r in range(0, BH, per)]


def _chunks(BH: int, heads: int, group: int, segq, segkv):
    """Per launch: the q-row slice, the kv-row slice and the chunk's
    segment-id rows (views, no copies)."""
    for r0, r1 in row_chunks(BH, heads, GRID_ROWS_MAX):
        b0, b1 = r0 // heads, r1 // heads
        yield (slice(r0, r1), slice(r0 // group, r1 // group),
               None if segq is None else segq[b0:b1],
               None if segkv is None else segkv[b0:b1])


def _seg_pair(segment_ids_q, segment_ids_kv):
    if (segment_ids_q is None) != (segment_ids_kv is None):
        raise ValueError("pass both segment_ids_q and segment_ids_kv, "
                         "or neither")
    if segment_ids_q is None:
        return None, None
    return (segment_ids_q.to(torch.int32).contiguous(),
            segment_ids_kv.to(torch.int32).contiguous())


def _keep_mask(T: int, Tk: int, segq, segkv, causal: bool, device):
    """The references' mask, broadcastable to (B, KVH, G, T, Tk): causal
    over local indices ∧ same segment; None when nothing is masked."""
    mask = None
    if causal:
        rows = torch.arange(T, device=device)
        cols = torch.arange(Tk, device=device)
        mask = (rows[:, None] >= cols[None, :])[None, None, None]
    if segq is not None:
        seg = (segq[:, :, None] == segkv[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    return mask


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              segment_ids_q=None, segment_ids_kv=None):
    """Plain PyTorch version of the flash forward, in one pass.

    q (B, T, H, D); k, v (B, T, KVH, D). Scores ``q·kᵀ·D^-½`` and the
    softmax are float32; ``p @ v`` accumulates in float32 on float32
    copies of ``v``. Returns ``(out (B, T, H, D) in q.dtype,
    lse (B, H, T) float32)``.
    """
    B, T, H, D = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    segq, segkv = _seg_pair(segment_ids_q, segment_ids_kv)
    qf = q.float().reshape(B, T, KVH, G, D).permute(0, 2, 3, 1, 4)
    qf = qf.reshape(B, KVH, G * T, D)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = (qf @ kf.transpose(-1, -2)).view(B, KVH, G, T, Tk) * D ** -0.5

    mask = _keep_mask(T, Tk, segq, segkv, causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = (p.view(B, KVH, G * T, Tk) @ vf).view(B, KVH, G, T, D)
    out = acc / torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l))[..., 0]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)
    return out, lse.reshape(B, H, T)


def flash_attention_reference_bh(q, k, v, segq=None, segkv=None, *,
                                 heads: int, group: int, causal: bool):
    """``flash_attention_reference`` in the kernels' layout and with
    ``flash_fwd``'s signature: q (B·heads, T, D), k/v (B·heads/group, T,
    D) -> (O like q, lse (B·heads, T) float32)."""
    BH, T, D = q.shape
    B, KVH = BH // heads, heads // group
    out, lse = flash_attention_reference(
        q.view(B, heads, T, D).transpose(1, 2),
        k.view(B, KVH, T, D).transpose(1, 2),
        v.view(B, KVH, T, D).transpose(1, 2),
        causal=causal, segment_ids_q=segq, segment_ids_kv=segkv)
    return out.transpose(1, 2).reshape(BH, T, D), lse.reshape(BH, T)


def flash_attention_bwd_reference(q, k, v, out, lse, do, segq=None,
                                  segkv=None, *, heads: int, group: int,
                                  causal: bool):
    """Plain PyTorch version of both backward kernels, with ``flash_bwd``'s
    signature (the port of ``_flash_bwd_xla``, in one float32 pass).

    dS = P∘(dP − δ)·D^-½ with P = exp(S − lse) (0 where masked, by
    selection: an orphan row's ``exp(S − NEG_INF)`` is inf), dP = dO·Vᵀ,
    δ = rowsum(dO∘O); dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO, the grouped q
    heads folded onto their kv head by a float32 sum. Returns
    ``(dq like q, dk like k, dv like v)``.
    """
    BH, T, D = q.shape
    B, KVH = BH // heads, heads // group
    segq, segkv = _seg_pair(segq, segkv)

    def per_group(t):      # (B·heads, T, D) -> (B, KVH, G, T, D) float32
        return t.float().view(B, KVH, group, T, D)

    qf, dof = per_group(q), per_group(do)
    kf = k.float().view(B, KVH, 1, T, D)
    vf = v.float().view(B, KVH, 1, T, D)
    delta = (dof * per_group(out)).sum(-1, keepdim=True)
    s = (qf @ kf.transpose(-1, -2)) * D ** -0.5
    p = torch.exp(s - lse.view(B, KVH, group, T, 1))
    mask = _keep_mask(T, T, segq, segkv, causal, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * D ** -0.5
    dq = ds @ kf
    dk = (ds.transpose(-1, -2) @ qf).sum(2)
    dv = (p.transpose(-1, -2) @ dof).sum(2)
    return (dq.reshape(BH, T, D).to(q.dtype),
            dk.reshape(B * KVH, T, D).to(k.dtype),
            dv.reshape(B * KVH, T, D).to(v.dtype))


def _check_kernel_inputs(who: str, q, k, v, segq, segkv, *, heads: int,
                         group: int, extra=()) -> int:
    """Raise on anything the kernels do not take; return B. ``extra``
    lists further (name, tensor) pairs shaped like q."""
    tensors = (("q", q), ("k", k), ("v", v), *extra)
    if not all(t.is_cuda for _, t in tensors):
        raise ValueError(f"{who} launches on CUDA tensors only")
    BH, T, D = q.shape
    if any(t.dtype not in KERNEL_DTYPES or t.dtype != q.dtype
           for _, t in tensors):
        raise TypeError(f"{who} takes bf16 tensors, got "
                        f"{[str(t.dtype) for _, t in tensors]}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    if BH % heads or heads % group:
        raise ValueError(f"bad heads={heads} / group={group} for "
                         f"{BH} q rows")
    B = BH // heads
    if k.shape != (BH // group, T, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be {(BH // group, T, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    dev = torch.cuda.current_device()
    for name, t in tensors:
        if name not in ("k", "v") and t.shape != q.shape:
            raise ValueError(f"{name} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
        if t.device.index != dev:
            raise ValueError(f"{name} is on {t.device}, not the current "
                             f"device cuda:{dev}")
    if (segq is None) != (segkv is None):
        raise ValueError("pass both segq and segkv, or neither")
    if segq is not None:
        for name, t in (("segq", segq), ("segkv", segkv)):
            if (t.dtype != torch.int32 or tuple(t.shape) != (B, T)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name} must be contiguous int32 "
                                 f"{(B, T)} on {q.device}")
    return B


def _check_row_stats(who: str, q, **rows):
    """Per-q-row float32 statistics (lse, δ): (B·heads, T) contiguous."""
    for name, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:2])
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{who}: {name} must be contiguous float32 "
                             f"{tuple(q.shape[:2])} on {q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, err: int, who: str):
    from kubeflow_rm_tpu_torch.kernels import build

    if err:
        raise RuntimeError(f"{who} launch failed: CUDA error {err} "
                           f"({build.error_string(lib, err)})")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              segq: torch.Tensor | None = None,
              segkv: torch.Tensor | None = None, *,
              heads: int, group: int, causal: bool):
    """Launch the Hopper flash forward kernel.

    q (B·heads, T, D), k/v (B·heads/group, T, D): contiguous bf16 on
    the current CUDA device, D in ``KERNEL_HEAD_DIMS``. segq/segkv:
    optional (B, T) int32. Returns ``(O (B·heads, T, D) bf16,
    lse (B·heads, T) float32)``. Raises on anything the kernel does
    not take, and when a launch is refused. Above ``GRID_ROWS_MAX`` rows
    it launches once per ``row_chunks`` range, on views.
    """
    from kubeflow_rm_tpu_torch.kernels import build

    _check_kernel_inputs("flash_fwd", q, k, v, segq, segkv, heads=heads,
                         group=group)
    BH, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    lib = build.load("flash_fwd")
    for qs, ks, sq, skv in _chunks(BH, heads, group, segq, segkv):
        err = lib.kfrm_flash_fwd(
            q[qs].data_ptr(), k[ks].data_ptr(), v[ks].data_ptr(), _ptr(sq),
            _ptr(skv), out[qs].data_ptr(), lse[qs].data_ptr(),
            qs.stop - qs.start, heads, T, D, group, int(bool(causal)),
            ctypes.c_float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, "flash_fwd")
        flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, segq=None, segkv=None, *,
                 heads: int, group: int, causal: bool) -> torch.Tensor:
    """Launch the Hopper dQ kernel (``_dq_kernel``'s counterpart).

    q, do (B·heads, T, D) and k/v (B·heads/group, T, D) bf16; lse and
    δ = rowsum(dO∘O) (B·heads, T) float32. Returns dq like q. One launch
    per ``row_chunks`` range."""
    from kubeflow_rm_tpu_torch.kernels import build

    _check_kernel_inputs("flash_bwd_dq", q, k, v, segq, segkv, heads=heads,
                         group=group, extra=(("do", do),))
    _check_row_stats("flash_bwd_dq", q, lse=lse, delta=delta)
    BH, T, D = q.shape
    dq = torch.empty_like(q)
    lib = build.load("flash_bwd")
    for qs, ks, sq, skv in _chunks(BH, heads, group, segq, segkv):
        err = lib.kfrm_flash_bwd_dq(
            q[qs].data_ptr(), k[ks].data_ptr(), v[ks].data_ptr(),
            do[qs].data_ptr(), lse[qs].data_ptr(), delta[qs].data_ptr(),
            _ptr(sq), _ptr(skv), dq[qs].data_ptr(), qs.stop - qs.start,
            heads, T, D, group, int(bool(causal)), ctypes.c_float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, "flash_bwd_dq")
        flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, segq=None, segkv=None, *,
                  heads: int, group: int, causal: bool):
    """Launch the Hopper dK/dV kernel (``_dkv_kernel``'s counterpart,
    with the GQA fold done inside: one CTA owns a kv head's tile and
    loops over its group's q heads). Same inputs as ``flash_bwd_dq``;
    returns ``(dk like k, dv like v)``. One launch per ``row_chunks``
    range (a chunk's kv rows are its q rows over ``group``)."""
    from kubeflow_rm_tpu_torch.kernels import build

    _check_kernel_inputs("flash_bwd_dkv", q, k, v, segq, segkv,
                         heads=heads, group=group, extra=(("do", do),))
    _check_row_stats("flash_bwd_dkv", q, lse=lse, delta=delta)
    BH, T, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = build.load("flash_bwd")
    for qs, ks, sq, skv in _chunks(BH, heads, group, segq, segkv):
        err = lib.kfrm_flash_bwd_dkv(
            q[qs].data_ptr(), k[ks].data_ptr(), v[ks].data_ptr(),
            do[qs].data_ptr(), lse[qs].data_ptr(), delta[qs].data_ptr(),
            _ptr(sq), _ptr(skv), dk[ks].data_ptr(), dv[ks].data_ptr(),
            ks.stop - ks.start, heads, T, D, group, int(bool(causal)),
            ctypes.c_float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, "flash_bwd_dkv")
        flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, out, lse, do, segq=None, segkv=None, *,
              heads: int, group: int, causal: bool):
    """The flash backward on the card: δ = rowsum(dO∘O) in float32 (a
    torch expression, as in JAX, ``:387``), then the dQ and the dK/dV
    kernels. Takes ``flash_fwd``'s inputs and outputs and dO like O;
    returns ``(dq, dk, dv)`` like q, k, v."""
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, segq, segkv, heads=heads,
                      group=group, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, segq, segkv,
                           heads=heads, group=group, causal=causal)
    return dq, dk, dv


def _launches_kernel(t: torch.Tensor) -> bool:
    """The node takes the kernels for a CUDA tensor and their plain
    versions for a CPU one — the only place the choice is made."""
    return t.is_cuda


# ---------------------------------------------------------------------
# the autograd node
# ---------------------------------------------------------------------

@torch.library.custom_op("kfrm::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              segq: Optional[torch.Tensor], segkv: Optional[torch.Tensor],
              heads: int, group: int, causal: bool,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    fwd = flash_fwd if _launches_kernel(q) else flash_attention_reference_bh
    return fwd(q, k, v, segq, segkv, heads=heads, group=group,
               causal=causal)


@_flash_op.register_fake
def _(q, k, v, segq, segkv, heads, group, causal):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.custom_op("kfrm::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, segq: Optional[torch.Tensor],
                  segkv: Optional[torch.Tensor], out: torch.Tensor,
                  lse: torch.Tensor, heads: int, group: int, causal: bool,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    bwd = flash_bwd if _launches_kernel(q) else flash_attention_bwd_reference
    return bwd(q, k, v, out, lse, do, segq, segkv, heads=heads,
               group=group, causal=causal)


@_flash_bwd_op.register_fake
def _(do, q, k, v, segq, segkv, out, lse, heads, group, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, segq, segkv, heads, group, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, segq, segkv, out, lse)
    ctx.meta = (heads, group, causal)
    ctx.mark_non_differentiable(lse)


def _backward(ctx, dout, _dlse):
    q, k, v, segq, segkv, out, lse = ctx.saved_tensors
    heads, group, causal = ctx.meta
    dq, dk, dv = _flash_bwd_op(dout.contiguous(), q, k, v, segq, segkv, out,
                               lse, heads, group, causal)
    return dq, dk, dv, None, None, None, None, None


_flash_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             segment_ids_q=None, segment_ids_kv=None):
    """``flash_attention`` that also returns ``lse`` (B, H, T) float32.

    Both devices go through ``torch.ops.kfrm.flash_attention``: a CUDA
    tensor launches the kernels (forward now, backward under autograd)
    or raises; a CPU tensor takes their plain versions.
    """
    B, T, H, D = q.shape
    KVH = k.shape[2]
    if H % KVH:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {KVH}")
    if k.shape[1] != T:
        raise ValueError("flash attention is self-attention: Tq == Tk")
    segq, segkv = _seg_pair(segment_ids_q, segment_ids_kv)
    qh = q.transpose(1, 2).reshape(B * H, T, D).contiguous()
    kh = k.transpose(1, 2).reshape(B * KVH, T, D).contiguous()
    vh = v.transpose(1, 2).reshape(B * KVH, T, D).contiguous()
    out, lse = _flash_op(qh, kh, vh, segq, segkv, H, H // KVH, bool(causal))
    return out.view(B, H, T, D).transpose(1, 2), lse.view(B, H, T)


def flash_attention(q, k, v, *, causal: bool = True,
                    segment_ids_q=None, segment_ids_kv=None):
    """Flash attention with the ``dot_product_attention`` layout:
    q (B, T, H, D); k, v (B, T, KVH, D) -> (B, T, H, D)."""
    out, _ = flash_attention_with_lse(
        q, k, v, causal=causal, segment_ids_q=segment_ids_q,
        segment_ids_kv=segment_ids_kv)
    return out
