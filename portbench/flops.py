"""Operation and byte counts the per-layer metrics divide by.

These are the benchmark's own, not the program's: a later change to the
program is held to the same work.

- Model FLOPs a trained token: 2 per matmul parameter forward, 2 more
  for the input gradient backward, and 2 more for a weight gradient
  where the weight trains (a frozen base: 4 per parameter; the LoRA
  adapters: 6). A mixture counts the router and ``top_k`` experts a
  token, not the experts it skips nor the dispatch and combine
  products. Attention counts the score and value products of the causal
  pairs inside one document: 4·hd a pair and head forward, 8·hd
  backward. Recomputation (remat) is not counted.
- A flash kernel launch: the same-document causal pairs at 4·hd (the
  forward), 6·hd (dq: scores, dP, dQ) and 8·hd (dk/dv: scores, dV, dP,
  dK) a pair and head, and every input read once and every output
  written once. Its bound is the larger of FLOPs over the peak rate and
  bytes over the peak bandwidth.
"""

from __future__ import annotations

from portbench.arch import Arch

#: NVIDIA's data sheet for the H100 SXM: dense bf16 FLOP/s, HBM bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16, F32, I32 = 2, 4, 4


def causal_pairs(doc_lengths) -> int:
    """(query, key) pairs with key <= query inside each document."""
    return sum(n * (n + 1) // 2 for n in doc_lengths)


def frozen_matmul_params(a: Arch) -> int:
    """Matmul parameters a token passes through (embedding gather and
    norm gains excluded; a mixture's active experts and its router)."""
    D, hd = a.dim, a.head_dim
    attn = D * a.heads * hd + 2 * D * a.kv_heads * hd + a.heads * hd * D
    if a.moe:
        ffn = a.top_k * 3 * D * a.ffn + D * a.experts
    else:
        ffn = 3 * D * a.ffn
    return a.layers * (attn + ffn) + D * a.vocab


def lora_params(a: Arch, rank: int, targets) -> int:
    outs = {"wq": a.heads * a.head_dim, "wk": a.kv_heads * a.head_dim,
            "wv": a.kv_heads * a.head_dim, "wo": a.dim}
    ins = {"wo": a.heads * a.head_dim}
    return a.layers * sum(rank * (ins.get(t, a.dim) + outs[t])
                          for t in targets)


def train_step_flops(a: Arch, rows: list[list[int]], lora_rank: int,
                     lora_targets) -> float:
    """Model FLOPs of one LoRA step over ``rows`` (each a list of the
    document lengths packed into it)."""
    tokens = sum(sum(r) for r in rows)
    mat = (4.0 * frozen_matmul_params(a)
           + 6.0 * lora_params(a, lora_rank, lora_targets)) * tokens
    pairs = sum(causal_pairs(r) for r in rows)
    attn = 12.0 * a.head_dim * a.heads * a.layers * pairs
    return mat + attn


def flash_launch(kind: str, a: Arch, rows: list[list[int]]) -> dict:
    """FLOPs, bytes and the bound in seconds of one launch of ``kind``
    (``fwd``, ``dq`` or ``dkv``) over a batch of ``rows``, each a list of
    the document lengths packed into a row of equal length."""
    B, T = len(rows), sum(rows[0])
    hd, H, KVH = a.head_dim, a.heads, a.kv_heads
    pairs = sum(causal_pairs(r) for r in rows)
    q = B * T * H * hd * BF16          # q, o, do, dq
    kv = B * T * KVH * hd * BF16       # k, v, dk, dv
    row = B * H * T * F32              # lse, delta
    seg = 2 * B * T * I32              # segment ids of q and kv
    flops_per_pair, nbytes = {
        "fwd": (4, q + 2 * kv + seg + q + row),
        "dq": (6, q + 2 * kv + q + 2 * row + seg + q),
        "dkv": (8, q + 2 * kv + q + 2 * row + seg + 2 * kv),
    }[kind]
    flops = flops_per_pair * hd * H * pairs
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)}
