"""Multi-head attention (counterpart of
``kubeflow_rm_tpu/ops/attention.py``).

Two paths behind one signature:

- **dense**: one batched matmul for scores (float32 accumulation), a
  float32 softmax, one batched matmul for the output. It takes every
  mask the model needs (explicit positions, segments, an additive
  bias) and serves the KV-cached decode path.
- **flash**: the hand-written Hopper kernel
  (``ops/flash_attention.py``) for causal self-attention over local
  indices with optional segment ids — the training-style forward.

Which path runs is decided before the call by ``flash_eligible`` and
the tensor's device; a kernel failure is never caught and retried on
the dense path.

GQA (n_kv_heads < n_heads) reshapes queries to (kv_head, group):
query head ``h`` reads kv head ``h // G``, and K/V are never repeated
in memory.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

NEG_INF = -2.0**30  # large-but-finite: keeps fp32 softmax NaN-free on fully masked rows

IMPLS = ("auto", "flash", "dense")

#: the device type the dispatch decision takes a tensor to be on (None:
#: its own). The cost model's walk sets "cuda" so that fake CPU tensors
#: take the card's path (``analysis.torchcheck.costmodel``).
_AS_DEVICE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "kfrm_as_device", default=None)


@contextlib.contextmanager
def as_device(kind: str | None):
    """Within the block, ``impl="auto"`` decides as if every tensor lay
    on a device of type ``kind`` ("cuda": the flash op wherever
    ``flash_eligible``); None leaves the decision to the tensors."""
    token = _AS_DEVICE.set(kind)
    try:
        yield
    finally:
        _AS_DEVICE.reset(token)


def on_card(t: torch.Tensor) -> bool:
    """Whether the dispatch decision takes ``t`` to be on the card."""
    kind = _AS_DEVICE.get()
    return t.is_cuda if kind is None else kind == "cuda"


def attention_mask(
    Tq: int,
    Tk: int,
    *,
    causal: bool = True,
    positions_q: torch.Tensor | None = None,
    positions_kv: torch.Tensor | None = None,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor | None:
    """Boolean keep-mask, (Tq, Tk) or (B, Tq, Tk), or None if unmasked.

    Causality uses global positions when given (packed sequences, the
    KV cache); segment ids additionally restrict attention to
    ``seg_q == seg_kv``.
    """
    mask = None
    if causal:
        if positions_q is None:
            rows = torch.arange(Tq, device=device)
            cols = torch.arange(Tk, device=device)
            mask = rows[:, None] >= cols[None, :]
        else:
            mask = positions_q[:, :, None] >= positions_kv[:, None, :]
    if segment_ids_q is not None:
        seg = segment_ids_q[:, :, None] == segment_ids_kv[:, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def flash_eligible(q, k, *, causal, positions_q, bias) -> bool:
    """Can the flash kernel compute this call exactly?

    The JAX predicate — causal self-attention over local indices (no
    explicit positions), no additive bias, ``Tq == Tk``, ``D % 8 == 0``
    — plus what the kernel was built for: a head dim in
    ``KERNEL_HEAD_DIMS`` and bf16 inputs. Unlike the TPU kernel, the
    CUDA kernel masks a ragged last tile itself, so any ``T`` is
    eligible (the JAX predicate needs a block that divides ``T``), and
    any B·H: the wrappers launch once per ``GRID_ROWS_MAX`` rows.
    """
    from kubeflow_rm_tpu_torch.ops.flash_attention import (
        KERNEL_DTYPES, KERNEL_HEAD_DIMS,
    )

    D = q.shape[-1]
    return (causal and bias is None and positions_q is None
            and q.shape[1] == k.shape[1] and D % 8 == 0
            and D in KERNEL_HEAD_DIMS and q.dtype in KERNEL_DTYPES)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    positions_q: torch.Tensor | None = None,
    positions_kv: torch.Tensor | None = None,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Scaled dot-product attention.

    Args:
      q: (B, Tq, H, D) queries.
      k, v: (B, Tk, KVH, D); H must be a multiple of KVH.
      causal: causal mask — ``pos_q >= pos_kv`` when positions are
        given, else lower-triangular over local indices.
      segment_ids_q / segment_ids_kv: optional (B, T) segment ids.
      bias: optional additive bias broadcastable to (B, H, Tq, Tk).
      impl: "auto" (the flash kernel for a CUDA tensor when
        ``flash_eligible``, else dense), "flash" (always the flash
        wrapper, which runs its plain version on a CPU tensor) or
        "dense".

    Returns:
      (B, Tq, H, D) in q.dtype.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "flash" and (bias is not None or positions_q is not None):
        raise ValueError(
            "impl='flash' cannot represent an additive bias or explicit "
            "positions; use impl='dense' (packed sequences need only "
            "segment ids)")
    use_flash = impl == "flash" or (
        impl == "auto" and on_card(q)
        and flash_eligible(q, k, causal=causal, positions_q=positions_q,
                           bias=bias))
    if use_flash:
        from kubeflow_rm_tpu_torch.ops.flash_attention import (
            flash_attention,
        )
        return flash_attention(q, k, v, causal=causal,
                               segment_ids_q=segment_ids_q,
                               segment_ids_kv=segment_ids_kv)

    B, Tq, H, D = q.shape
    _, Tk, KVH, _ = k.shape
    if H % KVH:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {KVH}")
    G = H // KVH

    # (B, KVH, G*Tq, D) against (B, KVH, Tk, D): one bmm per kv head.
    # The scale is applied to q in its own dtype (as the JAX path
    # does), then the product accumulates in float32 — the upcast
    # keeps bf16 products exact, like preferred_element_type=float32.
    qf = (q * D ** -0.5).reshape(B, Tq, KVH, G, D).permute(0, 2, 3, 1, 4)
    qf = qf.reshape(B, KVH, G * Tq, D).float()
    kf = k.permute(0, 2, 1, 3).float()
    scores = (qf @ kf.transpose(-1, -2)).view(B, KVH, G, Tq, Tk)

    if bias is not None:
        bias = torch.broadcast_to(bias, (B, H, Tq, Tk))
        scores = scores + bias.reshape(B, KVH, G, Tq, Tk).float()

    mask = attention_mask(
        Tq, Tk, causal=causal,
        positions_q=positions_q, positions_kv=positions_kv,
        segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
        device=q.device,
    )
    if mask is not None:
        mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
        scores = torch.where(mask, scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = probs.view(B, KVH, G * Tq, Tk) @ v.permute(0, 2, 1, 3)
    out = out.view(B, KVH, G, Tq, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Tq, H, D)
