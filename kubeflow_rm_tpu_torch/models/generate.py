"""KV-cached autoregressive generation (counterpart of
``kubeflow_rm_tpu/models/generate.py``).

Prefill runs the prompt in one chunk, then one token per step against a
preallocated cache. The JAX design carries over:

- **Static cache** (L, B, S, KVH, hd), written at a shared offset.
  The port writes it IN PLACE (JAX returns a new cache): the tensors of
  the cache passed to ``decode_chunk`` are updated, and the returned
  ``KVCache`` carries the advanced offset.
- **Position-masked attention**: unfilled and pad slots carry position
  ``_UNFILLED`` (int32 max), so the causal mask ``pos_q >= pos_kv``
  excludes them — the same mask as training, no second path.
- **Ragged batches**: ``pad_counts`` marks each row's left padding; pads
  get position ``_UNFILLED`` and real tokens are shifted so each row's
  first token sits at position 0, which makes a padded row generate
  what it would alone.

A write past the end of the cache raises (JAX's dynamic_update_slice
would clamp it silently).

The continuous-batching engine (``ContinuousBatchingEngine``) decodes a
pool of independent slots, each with its own write offset and position
counter, so requests join and leave a running batch at token
boundaries. Its two cache arms are the contiguous ``SlotCache`` here
and the block-paged pool of ``models.paging``. Speculative decoding
(``generate_speculative_fused``) is a host loop with one sync a round,
where JAX runs one ``lax.while_loop`` program.

The engine notes each prefill and decode call for the signature
sentinel and runs it inside the host-sync probe's ``engine.prefill`` /
``engine.decode`` region (``analysis.torchcheck``; free when off).

Every entry point takes plain and quantized trees alike
(``models.quantize``). ``generate_fused`` and the speculative decoder
unpack packed int4 once per call, before the decode loop, and the
engine once at construction; the per-token ``generate`` dequantizes
from the packed form at every step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync as _hostsync
from kubeflow_rm_tpu_torch.analysis.torchcheck import (
    recompile as _jit_sentinel,
)
from kubeflow_rm_tpu_torch.models.llama import (
    LlamaConfig, _epilogue, _mlp, _projector, embed, layer_params,
    stacked_layers,
)
from kubeflow_rm_tpu_torch.models.mixtral import MixtralConfig
from kubeflow_rm_tpu_torch.models.params import check_params
from kubeflow_rm_tpu_torch.models.quantize import (
    maybe_dequant, unpack_int4_params,
)
from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention
from kubeflow_rm_tpu_torch.ops.norms import rms_norm
from kubeflow_rm_tpu_torch.ops.rope import apply_rope, rope_angles
from kubeflow_rm_tpu_torch.parallel.moe import moe_ffn

_UNFILLED = torch.iinfo(torch.int32).max


@dataclass
class KVCache:
    k: torch.Tensor          # (L, B, S, KVH, hd) compute dtype
    v: torch.Tensor          # (L, B, S, KVH, hd)
    positions: torch.Tensor  # (B, S) int32; _UNFILLED marks empty slots
    offset: int              # next write index

    @property
    def max_len(self) -> int:
        return self.positions.shape[1]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: str | torch.device | None = None, *,
               mesh=None) -> KVCache:
    """An empty cache. ``mesh``: a rank's cache of ``batch`` rows
    (``cache_shardings``), its K/V heads those of
    ``MeshView.local_heads`` (repeated up to a multiple of tp where tp
    does not divide them) and its layers those of its pp stage."""
    from kubeflow_rm_tpu_torch.device import default_device

    device = default_device(device)
    L, KVH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if mesh is not None:
        from kubeflow_rm_tpu_torch.parallel.mesh import axis_size
        from kubeflow_rm_tpu_torch.parallel.sharded import kv_heads_local

        L //= axis_size(mesh, "pp")
        KVH = kv_heads_local(cfg, axis_size(mesh, "tp"))
    shape = (L, batch, max_len, KVH, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        positions=torch.full((batch, max_len), _UNFILLED,
                             dtype=torch.int32, device=device),
        offset=0,
    )


def decode_chunk(params: dict, cfg: LlamaConfig, cache: KVCache,
                 tokens: torch.Tensor,
                 pad_counts: torch.Tensor | None = None, *, view=None,
                 local_vocab: bool = False,
                 ) -> tuple[torch.Tensor, KVCache]:
    """Run ``tokens`` (B, Tc) through the model at the cache offset.

    Serves prefill (Tc = prompt length) and decode (Tc = 1). Returns
    (logits (B, Tc, V) float32, cache advanced by Tc); ``cache``'s
    tensors are written in place. Raises if the chunk does not fit.
    ``view`` (a ``parallel.sharded.MeshView``): ``params``, ``cache``
    and the rows are this rank's (``make_decode_step``), and with
    ``local_vocab`` the logits its tp share of the vocabulary.
    """
    B, Tc = tokens.shape
    off = cache.offset
    if off + Tc > cache.max_len:
        raise ValueError(f"chunk of {Tc} at offset {off} overflows the "
                         f"cache of {cache.max_len}")
    positions = (off + torch.arange(Tc, dtype=torch.int32,
                                    device=tokens.device)).expand(B, Tc)
    if pad_counts is not None:
        positions = positions - pad_counts.to(torch.int32)[:, None]
        positions = torch.where(positions < 0, _UNFILLED, positions)
    cache.positions[:, off:off + Tc] = positions

    def write_kv(i, k, v):
        cache.k[i, :, off:off + Tc] = k
        cache.v[i, :, off:off + Tc] = v
        return cache.k[i], cache.v[i]

    logits = _run_blocks(params, cfg, tokens, positions, cache.positions,
                         write_kv, view, local_vocab)
    return logits, KVCache(k=cache.k, v=cache.v, positions=cache.positions,
                           offset=off + Tc)


def _run_blocks(params, cfg, tokens, positions, kv_positions, write_kv,
                view=None, local_vocab: bool = False):
    """Transformer trunk against the KV cache: embed, per layer
    attention over the whole cache (dense, position-masked) + FFN,
    final norm, lm head. ``write_kv(i, k, v)`` lands this chunk's K/V in
    layer ``i``'s cache and returns that layer's full (k, v). The FFN
    half is the family's: the dense SwiGLU, or the expert mixture on its
    dequantized ``moe*`` leaves with the router aux loss dropped (a
    training quantity). MoE capacity is per call (N = B·Tc tokens), so a
    decode step can drop a token that a full forward keeps, as in JAX.
    On a mesh (``view``) the heads are this rank's and the projections,
    the FFN, the embedding and the head are ``view``'s; on a pp mesh
    each stage runs its layers in turn (the others wait) and hands the
    activation on (``MeshView.stage_handoff``)."""
    B, Tc = tokens.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if view is not None:
        H, KVH = view.local_heads(cfg)

    # rope of a ~2^31 position is finite but wild; clamp pads to 0
    # (their K is masked out by the _UNFILLED position anyway)
    rope_pos = torch.where(positions == _UNFILLED, 0, positions)
    cos, sin = rope_angles(rope_pos, hd, cfg.rope_theta)
    x = embed(params, tokens, cfg, view)
    if isinstance(cfg, MixtralConfig) and view is not None:
        def ffn(layer, h):
            return moe_ffn(layer, h, cfg.moe, dtype=cfg.dtype, view=view)[0]
    elif isinstance(cfg, MixtralConfig):
        def ffn(layer, h):
            dq = {k: (maybe_dequant(v, cfg.dtype) if k.startswith("moe")
                      else v) for k, v in layer.items()}
            return moe_ffn(dq, h, cfg.moe, dtype=cfg.dtype)[0]
    else:
        def ffn(layer, h):
            return _mlp(cfg, layer, h, view)
    blocks = params["blocks"]

    def stage(x):
        for i in range(stacked_layers(blocks)):
            layer = layer_params(blocks, i)
            proj = _projector(cfg, layer, view)
            h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
            q = apply_rope(proj("wq", h).reshape(B, Tc, H, hd), cos, sin)
            k = apply_rope(proj("wk", h).reshape(B, Tc, KVH, hd), cos, sin)
            v = proj("wv", h).reshape(B, Tc, KVH, hd)
            ck, cv = write_kv(i, k, v)
            attn = dot_product_attention(
                q, ck, cv, causal=True,
                positions_q=positions, positions_kv=kv_positions)
            x = x + proj("wo", attn.reshape(B, Tc, H * hd))
            x = x + ffn(layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
        return x

    if view is None or view.pp == 1:
        x = stage(x)
    else:
        for s in range(view.pp):
            if s == view.stage:
                x = stage(x)
            x = view.stage_handoff(x, s)
    return _epilogue(params, x, cfg, view, local_vocab=local_vocab)


def _pick(last: torch.Tensor, generator: torch.Generator | None, *,
          temperature: float, top_k: int | None) -> torch.Tensor:
    """Next token from last-position logits (B, V): greedy argmax (the
    first maximum, as ``jnp.argmax``) at temperature 0, else a
    (top-k-truncated) categorical draw from ``generator``. The one
    sampler of both decode entry points."""
    if temperature <= 0:
        return last.argmax(dim=-1).to(torch.int32)
    scaled = last / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _check(prompt, *, max_new_tokens, max_len, temperature, generator):
    if prompt.ndim != 2 or prompt.dtype.is_floating_point:
        raise ValueError("prompt must be a (B, T) integer tensor")
    Tp = prompt.shape[1]
    S = max_len or (Tp + max_new_tokens)
    if S < Tp + max_new_tokens:
        raise ValueError(f"max_len={S} < prompt {Tp} + new {max_new_tokens}")
    if temperature > 0 and generator is None:
        raise ValueError(
            "sampling (temperature > 0) requires a torch.Generator")
    return S


def _decode_loop(params, cfg, prompt, generator, *, max_new_tokens,
                 temperature, top_k, eos_id, total_len, pad_counts,
                 view=None):
    """Prefill, then ``max_new_tokens`` picks; a row that emitted
    ``eos_id`` keeps emitting it. On a mesh (``view``) the rows and the
    cache are this rank's."""
    B, Tp = prompt.shape
    cache = init_cache(cfg, B, total_len, prompt.device,
                       mesh=None if view is None else view.mesh)
    local = view is not None
    logits, cache = decode_chunk(params, cfg, cache, prompt, pad_counts,
                                 view=view, local_vocab=local)
    last = logits[:, -1, :]
    out = torch.empty((B, Tp + max_new_tokens), dtype=torch.int32,
                      device=prompt.device)
    out[:, :Tp] = prompt
    done = torch.zeros((B,), dtype=torch.bool, device=prompt.device)
    for i in range(max_new_tokens):
        if view is None:
            nxt = _pick(last, generator, temperature=temperature,
                        top_k=top_k)
        else:
            nxt = view.pick(last, generator, temperature=temperature,
                            top_k=top_k, sampler=_pick)
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        out[:, Tp + i] = nxt
        if i + 1 < max_new_tokens:
            logits, cache = decode_chunk(params, cfg, cache, nxt[:, None],
                                         pad_counts, view=view,
                                         local_vocab=local)
            last = logits[:, -1, :]
    return out


def generate(params: dict, cfg: LlamaConfig, prompt: torch.Tensor, *,
             max_new_tokens: int, generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int | None = None,
             eos_id: int | None = None, max_len: int | None = None,
             pad_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Continue ``prompt`` (B, Tp) by ``max_new_tokens`` tokens:
    (B, Tp + max_new_tokens) int32.

    ``temperature`` 0 is greedy; otherwise softmax sampling from
    ``generator``, optionally truncated to the ``top_k`` highest logits.
    Rows that emit ``eos_id`` repeat it. ``pad_counts`` (B,) marks
    left padding (see ``decode_chunk``).
    """
    S = _check(prompt, max_new_tokens=max_new_tokens, max_len=max_len,
               temperature=temperature, generator=generator)
    with torch.no_grad():
        return _decode_loop(
            params, cfg, prompt, generator, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, eos_id=eos_id,
            total_len=S, pad_counts=pad_counts)


def generate_fused(params: dict, cfg: LlamaConfig, prompt: torch.Tensor, *,
                   max_new_tokens: int,
                   generator: torch.Generator | None = None,
                   temperature: float = 0.0, top_k: int | None = None,
                   eos_id: int | None = None, max_len: int | None = None,
                   pad_counts: torch.Tensor | None = None) -> torch.Tensor:
    """``generate`` as one call under ``torch.inference_mode`` — the
    entry point the server uses, with the same argument checks.

    In JAX this is one compiled program (prefill + ``lax.scan``).
    Eager PyTorch has no such program, so the body is the same loop as
    ``generate`` and greedy output is identical; capturing the decode
    step in a CUDA graph is the optimisation that would make it one
    launch per step. Packed int4 is unpacked once, before the loop
    (``unpack_int4_params``; a no-op on a tree that holds none), so the
    steps read loop-invariant int8 groups.
    """
    S = _check(prompt, max_new_tokens=max_new_tokens, max_len=max_len,
               temperature=temperature, generator=generator)
    with torch.inference_mode():
        return _decode_loop(
            unpack_int4_params(params), cfg, prompt, generator,
            max_new_tokens=max_new_tokens,
            temperature=float(temperature), top_k=top_k, eos_id=eos_id,
            total_len=S, pad_counts=pad_counts)


# ---------------------------------------------------------------------
# decode on a mesh
# ---------------------------------------------------------------------

#: the batch rows of a decode are split over these axes
_ROW_AXES = ("dp", "fsdp")


def cache_shardings(cfg: LlamaConfig, mesh) -> KVCache:
    """The spec tree of a ``KVCache`` on ``mesh``: layers over pp (each
    stage caches its own), batch over (dp, fsdp), KV heads over tp — the
    decode-time analogue of ``parallel.sharding`` (weights keep their
    training specs). Where tp does not divide the KV heads the global
    head axis is the repeated one, ``KVH·kv_rep``
    (``init_cache(..., mesh=)``)."""
    kv = ("pp", _ROW_AXES, None, "tp", None)
    return KVCache(k=kv, v=kv, positions=(_ROW_AXES, None), offset=())


def _decode_view(mesh, cfg, params):
    from kubeflow_rm_tpu_torch.parallel.sharded import MeshView

    view = MeshView(mesh, cfg, params)
    if view.sp > 1:
        raise ValueError("decode splits no sequence: the mesh's sp must "
                         "be 1")
    return view


def make_decode_step(example_params: dict, cfg: LlamaConfig, mesh):
    """``step(params, cache, tokens, pad_counts=None) -> (logits,
    cache)`` on ``mesh``: ``decode_chunk`` on this rank's shards
    (``shard_params``), its cache (``cache_shardings``: its stage's
    layers, (dp, fsdp) rows and tp heads, ``init_cache(..., mesh=)``)
    and its rows of ``tokens``; the logits are its rows and its tp share
    of the vocabulary, (rows, Tc, V/tp), as JAX's come back
    vocabulary-sharded. ``example_params`` is only inspected for its
    specs."""
    view = _decode_view(mesh, cfg, example_params)

    def step(params, cache, tokens, pad_counts=None):
        with torch.inference_mode():
            return decode_chunk(params, cfg, cache, tokens, pad_counts,
                                view=view, local_vocab=True)

    return step


def make_generate_step(example_params: dict, cfg: LlamaConfig, mesh, *,
                       max_new_tokens: int, total_len: int,
                       temperature: float = 0.0, top_k: int | None = None,
                       eos_id: int | None = None):
    """Sharded ``generate_fused``: ``step(params, prompt,
    generator=None, pad_counts=None) -> tokens``.

    Every rank calls with its shards (``shard_params``) and the same
    global ``prompt`` (B, T) and ``pad_counts``; each decodes its
    (dp, fsdp) rows on its tp heads with a cache that never leaves the
    card, and every rank gets the global (B, T + max_new_tokens)
    tokens back. Greedy output equals ``generate_fused`` on one device:
    the logits stay split over tp and the argmax is taken across the
    ranks (``MeshView.pick``). Sampling gathers each row's logits and
    draws from each rank's ``generator``: seed it alike on every rank
    (the tp ranks of a row must draw the same token).
    ``example_params`` is only inspected for its specs.
    """
    from kubeflow_rm_tpu_torch.parallel.collectives import all_gather
    from kubeflow_rm_tpu_torch.parallel.mesh import axis_group
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        local_slices, shard_tensor,
    )

    view = _decode_view(mesh, cfg, example_params)
    rows = axis_group(mesh, _ROW_AXES)

    def step(params, prompt, generator=None, pad_counts=None):
        if total_len < prompt.shape[1] + max_new_tokens:
            raise ValueError(
                f"total_len={total_len} < prompt {prompt.shape[1]} + "
                f"new {max_new_tokens}")
        _check(prompt, max_new_tokens=max_new_tokens, max_len=total_len,
               temperature=temperature, generator=generator)
        mine = local_slices(prompt.shape, (_ROW_AXES, None), mesh)[0]
        local_pads = None if pad_counts is None else pad_counts[mine]
        with torch.inference_mode():
            out = _decode_loop(
                params, cfg, shard_tensor(prompt, (_ROW_AXES, None), mesh),
                generator, max_new_tokens=max_new_tokens,
                temperature=float(temperature), top_k=top_k, eos_id=eos_id,
                total_len=total_len, pad_counts=local_pads, view=view)
            return all_gather(out, rows, 0)

    return step


def rewind_cache(cache: KVCache, new_offset: int) -> KVCache:
    """Logically truncate the cache to ``new_offset`` filled slots.

    Slots at and after ``new_offset`` get position ``_UNFILLED`` (in
    place), so the causal mask hides their stale K/V from every later
    query and the K/V bytes need no clearing. The speculative decoder
    uses this to drop rejected draft tokens."""
    cache.positions[:, new_offset:] = _UNFILLED
    return KVCache(k=cache.k, v=cache.v, positions=cache.positions,
                   offset=new_offset)


def _speculative_loop(params, cfg, prompt, *, max_new_tokens, lookup_n,
                      draft_k, eos_id):
    """Prompt-lookup speculative decoding of one row (the body of JAX's
    ``_fused_speculative``, ``generate.py:377``): each round commits the
    greedy token, drafts the ``draft_k`` tokens that followed the most
    recent earlier occurrence of the trailing ``lookup_n``-gram,
    verifies them in one ``draft_k + 1``-wide chunk, keeps the longest
    agreeing prefix and rewinds the cache past the rest. The token
    buffer and the drafting live on the host; the round's one sync is
    the argmax of the verified chunk. Returns (tokens (1, Tp +
    max_new_tokens), model calls, committed count)."""
    Tp = prompt.shape[1]
    W = draft_k + 1
    target = Tp + max_new_tokens
    cache = init_cache(cfg, 1, target + W, prompt.device)
    buf = prompt[0].tolist()
    logits, cache = decode_chunk(params, cfg, cache, prompt)
    greedy = [int(logits[0, -1].argmax())]
    accepted, done, rounds = 0, False, 1
    while len(buf) < target and not done:
        nxt = greedy[accepted]
        buf.append(nxt)
        count = len(buf)
        tail = buf[count - lookup_n:]
        start = 0
        for p in range(count - lookup_n - 1, -1, -1):   # most recent hit
            if buf[p:p + lookup_n] == tail:
                start = p + lookup_n
                break
        # no hit: a draft from the buffer's head, rejected at no extra
        # cost (the chunk is W wide every round regardless)
        draft = (buf + [0] * W)[start:start + draft_k]
        chunk = torch.tensor([[nxt] + draft], dtype=torch.int32,
                             device=prompt.device)
        logits, cache = decode_chunk(params, cfg, cache, chunk)
        greedy = logits[0].argmax(-1).tolist()
        ok = 0
        while ok < draft_k and draft[ok] == greedy[ok]:
            ok += 1
        accepted = min(ok, max(0, min(target - count, draft_k)))
        buf.extend(draft[:accepted])
        if eos_id is not None and eos_id in [nxt] + draft[:accepted]:
            done = True
        cache = rewind_cache(cache, cache.offset - (W - 1 - accepted))
        rounds += 1
    count = len(buf)
    out = buf[:target] + [0] * (target - count)
    if eos_id is not None:
        # latch: everything after the first generated eos (and any slot
        # past count, if the loop stopped early) becomes eos
        first = next((p for p in range(Tp, target) if out[p] == eos_id),
                     target)
        out = [eos_id if (p > first or p >= count) else t
               for p, t in enumerate(out)]
    return (torch.tensor([out], dtype=torch.int32, device=prompt.device),
            rounds, count)


def generate_speculative_fused(params: dict, cfg: LlamaConfig,
                               prompt: torch.Tensor, *,
                               max_new_tokens: int, lookup_n: int = 3,
                               draft_k: int = 8,
                               eos_id: int | None = None,
                               stats: dict | None = None) -> torch.Tensor:
    """Prompt-lookup speculative decoding (batch 1, greedy):
    (1, Tp + max_new_tokens) int32, the tokens ``generate`` gives (held
    to it in float32; bf16 chunked numerics can resolve near-ties
    differently). ``stats``, when given, receives ``model_calls`` (the
    prefill plus one per verification round) and ``tokens_out``
    (generated tokens committed; fewer than ``max_new_tokens`` if eos
    fired)."""
    _check(prompt, max_new_tokens=max_new_tokens, max_len=None,
           temperature=0.0, generator=None)
    B, Tp = prompt.shape
    if B != 1:
        raise ValueError("speculative decoding is batch-1 "
                         f"(got batch {B}); batched requests amortize "
                         "weights already — use generate_fused")
    if Tp <= lookup_n:
        raise ValueError(f"prompt ({Tp}) must be longer than "
                         f"lookup_n ({lookup_n})")
    with torch.no_grad():
        out, rounds, count = _speculative_loop(
            unpack_int4_params(params), cfg, prompt,
            max_new_tokens=max_new_tokens,
            lookup_n=lookup_n, draft_k=draft_k, eos_id=eos_id)
    if stats is not None:
        stats["model_calls"] = rounds
        stats["tokens_out"] = count - Tp
    return out


# ---------------------------------------------------------------------------
# Continuous batching: fixed-capacity KV slots with PER-SLOT offsets.
#
# ``generate_fused`` runs a batch in lockstep: a 4-token reply waits for
# a 256-token neighbour, and no request can join a running batch. The
# engine below decouples rows: the cache is a pool of independent slots,
# each with its own write offset and next-position counter, so requests
# are admitted into free slots and retired from them at token
# boundaries while the other slots keep decoding. An inactive slot's
# query position is _UNFILLED, so whatever it writes that step is
# invisible to every real query, and each request's output is the one a
# solo ``generate_fused(max_len=slot_len)`` call gives.
# ---------------------------------------------------------------------------


@dataclass
class SlotCache:
    """KV pool for continuous batching: like ``KVCache``, but the write
    offset and the next token position are per-row tensors."""
    k: torch.Tensor          # (L, B, S, KVH, hd) compute dtype
    v: torch.Tensor          # (L, B, S, KVH, hd)
    positions: torch.Tensor  # (B, S) int32; _UNFILLED marks empty slots
    write_idx: torch.Tensor  # (B,) int32: next KV write slot per row
    pos_next: torch.Tensor   # (B,) int32: next token position per row


def init_slot_cache(cfg: LlamaConfig, slots: int, slot_len: int,
                    device: str | torch.device | None = None) -> SlotCache:
    from kubeflow_rm_tpu_torch.device import default_device

    device = default_device(device)
    L, KVH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (L, slots, slot_len, KVH, hd)
    return SlotCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        positions=torch.full((slots, slot_len), _UNFILLED,
                             dtype=torch.int32, device=device),
        write_idx=torch.zeros((slots,), dtype=torch.int32, device=device),
        pos_next=torch.zeros((slots,), dtype=torch.int32, device=device),
    )


@torch.no_grad()
def _install_row(cache: SlotCache, row_cache: KVCache, row: int,
                 n_real: int) -> SlotCache:
    """Copy a freshly prefilled single-request cache (B=1, same S) into
    slot ``row``, in place. ``n_real`` is the request's real prompt
    length (without left padding): the slot resumes at position n_real
    while its writes continue at the padded offset — where a fused
    left-padded batch would put them."""
    cache.k[:, row] = row_cache.k[:, 0]
    cache.v[:, row] = row_cache.v[:, 0]
    cache.positions[row] = row_cache.positions[0]
    cache.write_idx[row] = row_cache.offset
    cache.pos_next[row] = n_real
    return cache


@torch.no_grad()
def slot_decode_step(params, cfg, cache: SlotCache, tokens: torch.Tensor,
                     active: torch.Tensor):
    """One decode step over the whole slot pool, in place.

    ``tokens`` (B,) int32 is each slot's freshly sampled token;
    ``active`` (B,) bool masks live slots. Every row writes K/V at its
    OWN ``write_idx`` and attends at its OWN ``pos_next``. Inactive rows
    still flow through the matmuls but their query position is
    _UNFILLED and their counters do not advance, so their writes are
    invisible — the slot is rewritten whole on its next admission.
    Returns (last-position logits (B, V) float32, the cache).
    """
    B = tokens.shape[0]
    rows = torch.arange(B, device=tokens.device)
    wi = cache.write_idx.long()
    positions = torch.where(active, cache.pos_next, _UNFILLED)[:, None]
    cache.positions[rows, wi] = positions[:, 0]

    def write_kv(i, k, v):
        cache.k[i, rows, wi] = k[:, 0]
        cache.v[i, rows, wi] = v[:, 0]
        return cache.k[i], cache.v[i]

    logits = _run_blocks(params, cfg, tokens[:, None], positions,
                         cache.positions, write_kv)
    inc = active.to(torch.int32)
    cache.write_idx += inc
    cache.pos_next += inc
    return logits[:, -1, :], cache


def _pick_row(last: torch.Tensor, generator: torch.Generator | None, *,
              temperature: float, top_k: int | None) -> int:
    """``_pick`` for one slot's (V,) logits: the engine samples per slot
    (each request draws from its own generator) through the same
    sampler as both batch decode paths."""
    return int(_pick(last[None, :], generator, temperature=temperature,
                     top_k=top_k)[0])


def _bucket_len(n: int) -> int:
    """Next power of two ≥ n: the prefill padding buckets (the JAX
    engine's compile-shape policy, kept so both engines pad alike)."""
    b = 1
    while b < n:
        b *= 2
    return b


#: in-engine SLO classes, drained by weighted share at token boundaries
SLO_CLASSES = ("interactive", "batch", "best_effort")
DEFAULT_CLASS_WEIGHTS = {"interactive": 8, "batch": 3, "best_effort": 1}


class EngineRequest:
    """Handle returned by ``ContinuousBatchingEngine.submit``:
    ``tokens`` fills in as the request decodes; ``done`` flips when the
    slot retires (eos or max_new_tokens)."""

    _next_id = 0

    def __init__(self, prompt, *, max_new_tokens, eos_id, temperature,
                 top_k, generator, slo_class="interactive",
                 speculative=False):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = top_k
        self.generator = generator
        self.slo_class = slo_class
        # ``speculative`` runs the whole generation at admission through
        # ``generate_speculative_fused`` (batch/best_effort only);
        # ``chain`` is a serialized KV chain installed in place of
        # prefill (``models.paging.export_chain`` format)
        self.speculative = bool(speculative)
        self.chain = None
        self.tokens: list[int] = []
        self.done = False
        self.rid = EngineRequest._next_id
        EngineRequest._next_id += 1
        # decode-step counters at submit, admission and retirement
        self.submitted_step = None
        self.admitted_step = None
        self.finished_step = None


class ContinuousBatchingEngine:
    """Slot-based continuous-batching decode engine (counterpart of the
    JAX ``ContinuousBatchingEngine``, ``generate.py:774``).

    ``submit`` queues a request into its SLO class; ``step`` admits
    queued requests into free slots (one prefill each), samples each
    live slot's next token, retires slots that hit eos or their token
    budget, and runs ONE decode step for the slots still live — short
    requests leave (and new ones enter) mid-flight.

    Two cache arms:

    - ``paged=True`` (default): KV lives in a block pool
      (``models.paging``) with per-slot block tables, refcounted
      copy-on-write prefix sharing and LRU retention of retired prefix
      blocks.
    - ``paged=False``: the contiguous ``SlotCache``.

    Admission drains three priority-weighted class queues
    (``SLO_CLASSES``) by smooth weighted round-robin at token
    boundaries.

    The caches live on the parameters' device (the caller chose it when
    it placed them). Each request's greedy output is the one solo
    ``generate_fused(prompt[None], max_new_tokens=..., max_len=slot_len)``
    gives, cached prefix or not (token for token in float32; in bf16 a
    different batch or a split prefill may round differently). A sampled
    request draws from its own ``torch.Generator``. Packed int4 weights
    are unpacked once, at construction (``self.params``), so each step
    pays only the int8 dequant; int8 and plain trees are kept as given.
    """

    def __init__(self, params, cfg, *, slots: int = 8,
                 slot_len: int = 256, paged: bool = True,
                 block_size: int = 16, num_blocks: int | None = None,
                 class_weights: dict | None = None,
                 prefix_cache: bool = True):
        from kubeflow_rm_tpu_torch.models import paging

        check_params(params, cfg)
        self.cfg = cfg
        self.params = unpack_int4_params(params)
        self.device = params["embed"]["tokens"].device
        self.slots = slots
        self.slot_len = slot_len
        self.paged = paged
        if paged:
            if slot_len % block_size:
                raise ValueError(
                    f"slot_len {slot_len} must be a multiple of "
                    f"block_size {block_size}")
            self.block_size = block_size
            maxb = slot_len // block_size
            if num_blocks is None:
                # every slot fully packed + 50% headroom so retired
                # prefix blocks can be RETAINED instead of recycled
                num_blocks = (paging.RESERVED_BLOCKS + slots * maxb
                              + max(maxb, (slots * maxb) // 2))
            self.pool = paging.BlockPool(num_blocks, block_size)
            self.prefix_cache = prefix_cache
            self.cache = paging.init_paged_cache(
                cfg, slots, slot_len, num_blocks, block_size, self.device)
        else:
            self.block_size = None
            self.pool = None
            self.prefix_cache = False
            self.cache = init_slot_cache(cfg, slots, slot_len, self.device)
        self._slot_req: list[EngineRequest | None] = [None] * slots
        self._slot_blocks: list[list | None] = [None] * slots
        self._last: list[torch.Tensor | None] = [None] * slots  # (V,)
        self._queues = {c: [] for c in SLO_CLASSES}
        self.class_weights = dict(DEFAULT_CLASS_WEIGHTS)
        if class_weights:
            self.class_weights.update(class_weights)
        self._credits = {c: 0.0 for c in SLO_CLASSES}
        # counters surfaced by stats()
        self.decode_steps = 0
        self.prefills = 0
        self.occupancy_sum = 0
        self.admitted_total = 0
        self.finished_total = 0
        self.admitted_by_class = {c: 0 for c in SLO_CLASSES}
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        # disaggregation + speculative counters
        self.chain_installs = 0
        self.chains_exported = 0
        self.chains_adopted = 0
        self.speculative_requests = 0
        self.speculative_model_calls = 0
        self._spec_finished: list[EngineRequest] = []
        if _jit_sentinel.enabled():
            # prompt lengths bucket to powers of two (_bucket_len), so a
            # pow-2 slot_len admits at most log2(slot_len)+1 prefill
            # shapes; decode always runs the full (slots,) batch — ONE
            # shape, ever. The sentinel turns both into assertions.
            _jit_sentinel.set_limit("engine.prefill", slot_len.bit_length())
            _jit_sentinel.set_limit("engine.decode_step", 1)

    def _tensor(self, rows, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(rows, dtype=dtype, device=self.device)

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int,
               eos_id: int | None = None, temperature: float = 0.0,
               top_k: int | None = None,
               generator: torch.Generator | None = None,
               slo_class: str = "interactive",
               speculative: bool = False) -> EngineRequest:
        Tp = len(prompt)
        if Tp == 0:
            raise ValueError("empty prompt")
        if slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown slo_class {slo_class!r} "
                             f"(one of {SLO_CLASSES})")
        if speculative:
            # the speculative loop holds the device for the whole
            # generation — never for a latency-class request — and
            # prompt-lookup drafting is greedy by construction
            if slo_class == "interactive":
                raise ValueError(
                    "speculative decode is a batch/best_effort option "
                    "(interactive stays on the continuous-batching "
                    "path)")
            if temperature > 0:
                raise ValueError("speculative decode is greedy-only")
            if Tp <= 3:
                raise ValueError(
                    f"speculative decode needs a prompt longer than "
                    f"lookup_n=3 (got {Tp})")
        need = _bucket_len(Tp) + max_new_tokens
        if need > self.slot_len:
            raise ValueError(
                f"request needs {need} cache slots (prefill bucket "
                f"{_bucket_len(Tp)} + {max_new_tokens} new) > slot_len "
                f"{self.slot_len}")
        if self.paged:
            chunks = -(-(Tp + max_new_tokens) // self.block_size)
            if chunks > self.pool.usable_blocks:
                raise ValueError(
                    f"request needs {chunks} KV blocks > pool of "
                    f"{self.pool.usable_blocks} usable blocks")
        if temperature > 0 and generator is None:
            raise ValueError(
                "sampling (temperature > 0) requires a torch.Generator")
        req = EngineRequest(prompt, max_new_tokens=max_new_tokens,
                            eos_id=eos_id, temperature=temperature,
                            top_k=top_k, generator=generator,
                            slo_class=slo_class, speculative=speculative)
        req.submitted_step = self.decode_steps
        self._queues[slo_class].append(req)
        return req

    def install_chain(self, chain: dict, *, max_new_tokens: int,
                      eos_id: int | None = None,
                      temperature: float = 0.0,
                      top_k: int | None = None,
                      generator: torch.Generator | None = None,
                      slo_class: str = "interactive") -> EngineRequest:
        """Submit a request whose prefill is REPLACED by a serialized KV
        chain (``models.paging.export_chain`` format, made by a prefill
        replica for exactly this prompt): the chain's chunks seat in the
        pool and sampling starts from the carried last-token logits.
        Verification happens here, before queueing: a corrupted chunk
        raises ``ValueError`` and nothing is enqueued."""
        from kubeflow_rm_tpu_torch.models import paging

        if not self.paged:
            raise ValueError("install_chain requires the paged engine")
        paging.verify_chain(chain)
        if int(chain["block_size"]) != self.block_size:
            raise ValueError(
                f"chain block_size {chain['block_size']} != engine "
                f"block_size {self.block_size}")
        if chain.get("tokens") is None or chain.get("last_logits") is None:
            raise ValueError("install_chain needs a full chain "
                             "(tokens + last_logits); partial chains "
                             "go through adopt_chain")
        ck = chain["chunks_k"]
        if (ck.shape[0] != self.cache.k.shape[0]
                or tuple(ck.shape[2:]) != tuple(self.cache.k.shape[2:])):
            raise ValueError("chain chunk shape does not fit this "
                             "engine's cache")
        req = self.submit(chain["tokens"],
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          temperature=temperature, top_k=top_k,
                          generator=generator, slo_class=slo_class)
        req.chain = chain
        return req

    def adopt_chain(self, chain: dict) -> int:
        """Seat a foreign chain in the local pool as retained prefix
        cache — no slot, no request; the next ``submit`` of a prompt
        sharing the prefix hits it like a locally prefilled chain.
        Returns the number of chunks adopted (0 when the chain is
        already local or the pool is transiently full)."""
        from kubeflow_rm_tpu_torch.models import paging

        if not self.paged:
            raise ValueError("adopt_chain requires the paged engine")
        keys = list(zip(chain["covers"], chain["keys"]))
        if len(self.pool.lookup_chain(keys)) == len(keys):
            return 0
        with torch.no_grad():
            got = paging.import_chain(self.cache, self.pool, chain)
        if got is None:
            return 0
        _, blocks = got
        self.pool.decref(blocks)   # retained at ref 0 until evicted
        self.chains_adopted += 1
        return len(blocks)

    def chain_coverage(self, prompt) -> int:
        """Prompt tokens the local prefix cache already covers."""
        from kubeflow_rm_tpu_torch.models import paging

        if not self.paged or not self.prefix_cache:
            return 0
        keys = paging.prefix_keys(prompt, self.block_size)
        chain = self.pool.lookup_chain(keys)
        return keys[len(chain) - 1][0] if chain else 0

    def _next_queued(self) -> EngineRequest | None:
        """Smooth weighted round-robin over the non-empty class queues:
        every pick tops each contender up by its weight, the highest
        credit wins and pays back the round's total — each class's share
        of admissions converges to its weight share, and no non-empty
        class starves."""
        live = [c for c in SLO_CLASSES if self._queues[c]]
        if not live:
            return None
        total = sum(self.class_weights[c] for c in live)
        for c in live:
            self._credits[c] += self.class_weights[c]
        chosen = max(live, key=lambda c: (self._credits[c],
                                          -SLO_CLASSES.index(c)))
        self._credits[chosen] -= total
        return self._queues[chosen].pop(0)

    def _requeue_front(self, req: EngineRequest) -> None:
        self._queues[req.slo_class].insert(0, req)

    def evict_queued(self) -> list[EngineRequest]:
        """Pull every not-yet-admitted request back out (the drain path:
        a gateway re-routes them to another replica). Admitted slots are
        untouched — they finish here."""
        out: list[EngineRequest] = []
        for c in SLO_CLASSES:
            out.extend(self._queues[c])
            self._queues[c] = []
        return out

    def _admit(self) -> None:
        from kubeflow_rm_tpu_torch.models import paging

        for i in range(self.slots):
            if self._slot_req[i] is not None:
                continue
            while True:
                req = self._next_queued()
                if req is None:
                    return
                if req.speculative:
                    # runs whole at this boundary, never holds a slot
                    self._run_speculative(req)
                    continue
                break
            if self.paged and req.chain is not None:
                keys = paging.prefix_keys(req.prompt, self.block_size)
                if len(self.pool.lookup_chain(keys)) == len(keys):
                    # full local hit: adopt the cached blocks instead of
                    # seating duplicate chunks from the payload
                    req.chain = None
            if self.paged and req.chain is not None:
                last = self._admit_chain(i, req)
                if last is None:
                    self._requeue_front(req)
                    return
            elif self.paged:
                last = self._admit_paged(i, req)
                if last is None:
                    # transient block OOM: the head waits at the front
                    # of its class queue; blocks free as slots retire
                    # (or retained prefix blocks are evicted)
                    self._requeue_front(req)
                    return
                self.prefills += 1
            else:
                last = self._admit_contiguous(i, req)
                self.prefills += 1
            self._last[i] = last
            self._slot_req[i] = req
            req.admitted_step = self.decode_steps
            self.admitted_total += 1
            self.admitted_by_class[req.slo_class] += 1

    def _run_speculative(self, req: EngineRequest) -> None:
        """Run a speculative request whole through
        ``generate_speculative_fused`` (greedy); it finishes at this
        token boundary without taking a slot."""
        stats: dict = {}
        out = generate_speculative_fused(
            self.params, self.cfg, self._tensor([req.prompt]),
            max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
            stats=stats)
        toks = out[0, len(req.prompt):].tolist()
        if req.eos_id is not None and req.eos_id in toks:
            toks = toks[:toks.index(req.eos_id) + 1]
        req.tokens = toks
        req.done = True
        req.admitted_step = self.decode_steps
        req.finished_step = self.decode_steps
        self.admitted_total += 1
        self.admitted_by_class[req.slo_class] += 1
        self.finished_total += 1
        self.speculative_requests += 1
        self.speculative_model_calls += stats.get("model_calls", 0)
        self._spec_finished.append(req)

    @torch.no_grad()
    def _admit_contiguous(self, i: int, req: EngineRequest):
        Tp = len(req.prompt)
        Tb = _bucket_len(Tp)
        padded = self._tensor([[0] * (Tb - Tp) + req.prompt])
        pads = self._tensor([Tb - Tp])
        tmp = init_cache(self.cfg, 1, self.slot_len, self.device)
        _jit_sentinel.note("engine.prefill", padded)
        with _hostsync.region("engine.prefill"):
            logits, tmp = decode_chunk(self.params, self.cfg, tmp, padded,
                                       pads)
        _install_row(self.cache, tmp, i, Tp)
        return logits[0, -1, :]

    def _plan(self, prompt, budget: int, keys):
        """Block plan of one admission (``_admit_paged`` and
        ``prefill_chain``): the longest cached chain covers ``n_hit``
        prompt tokens (at most Tp-1: the last prompt token is always
        prefilled, its logits seed sampling), dropped back to a block
        boundary until the suffix's padding bucket fits the strip.
        Chunks fully inside the hit are shared; the chunk holding
        ``n_hit``, when mid-block, is FORKED (copy-on-write). Pins the
        sources before allocating — alloc may evict ref-0 retained
        blocks, and evicting one about to be read would corrupt the
        copy. ``keys`` are the prompt's ``prefix_keys`` (none without a
        prefix cache). Returns None on block OOM with the pins rolled
        back."""
        from kubeflow_rm_tpu_torch.models import paging

        pool, BS = self.pool, self.block_size
        Tp = len(prompt)
        chain = pool.lookup_chain(keys)
        n_hit = min(keys[len(chain) - 1][0] if chain else 0, Tp - 1)
        while n_hit > 0 and n_hit + _bucket_len(Tp - n_hit) > self.slot_len:
            n_hit = ((n_hit - 1) // BS) * BS
        shared_full = n_hit // BS
        fork = n_hit % BS != 0
        shared = chain[:shared_full]
        needed = -(-(Tp + budget) // BS)
        pins = chain[:shared_full + 1] if fork else shared
        pool.incref(pins)
        fresh = pool.alloc(needed - shared_full)
        if fresh is None:
            pool.decref(pins)
            return None
        if fork:
            pool.cow_forks += 1
        maxb = self.slot_len // BS
        load_row = [paging.NULL_BLOCK] * maxb
        load_row[:len(pins)] = pins
        final_row = [paging.NULL_BLOCK] * maxb
        final_row[:shared_full] = shared
        final_row[shared_full:needed] = fresh
        return dict(keys=keys, chain=chain, n_hit=n_hit,
                    shared_full=shared_full, fork=fork, shared=shared,
                    needed=needed, fresh=fresh, load_row=load_row,
                    final_row=final_row)

    def _prefill_suffix(self, plan, prompt):
        """``paged_prefill`` of the prompt's un-cached suffix,
        right-padded to its bucket."""
        from kubeflow_rm_tpu_torch.models import paging

        suffix = prompt[plan["n_hit"]:]
        Tc = _bucket_len(len(suffix))
        padded = self._tensor([suffix + [0] * (Tc - len(suffix))])
        _jit_sentinel.note("engine.prefill", padded)
        with _hostsync.region("engine.prefill"):
            return paging.paged_prefill(
                self.params, self.cfg, self.cache, plan["load_row"],
                plan["n_hit"], padded, len(suffix))

    def _register(self, keys, final_row) -> None:
        parent = None
        for covered, key in keys:
            self.pool.register(key, final_row[(covered - 1) // self.block_size],
                               parent=parent, covered=covered)
            parent = key

    def _admit_paged(self, i: int, req: EngineRequest):
        """Plan blocks, prefill the un-cached suffix, install. Returns the
        last real token's logits, or ``None`` on transient block OOM
        (pool state untouched)."""
        from kubeflow_rm_tpu_torch.models import paging

        keys = (paging.prefix_keys(req.prompt, self.block_size)
                if self.prefix_cache else [])
        plan = self._plan(req.prompt, req.max_new_tokens, keys)
        if plan is None:
            return None
        shared_full, needed = plan["shared_full"], plan["needed"]
        # owned chunks land in their blocks; shared chunks and tail
        # chunks past the allocation divert to SINK (never overwrite a
        # shared block, never touch NULL)
        dest_row = [blk if shared_full <= c < needed else paging.SINK_BLOCK
                    for c, blk in enumerate(plan["final_row"])]
        last, tk, tv, tpos = self._prefill_suffix(plan, req.prompt)
        paging.paged_install(self.cache, tk, tv, tpos, i, plan["final_row"],
                             dest_row, len(req.prompt))
        if plan["fork"]:
            self.pool.decref([plan["chain"][shared_full]])  # unpin source
        if self.prefix_cache:
            self._register(plan["keys"], plan["final_row"])
        self._slot_blocks[i] = plan["shared"] + plan["fresh"]
        self.prefix_hit_tokens += plan["n_hit"]
        self.prompt_tokens += len(req.prompt)
        return last

    @torch.no_grad()
    def _admit_chain(self, i: int, req: EngineRequest):
        """Seat a verified foreign chain straight into slot ``i``: its
        chunks land in freshly allocated blocks, the counters seat at
        the real prompt length, and sampling starts from the carried
        last-token logits — no prefill here. Returns ``None`` on
        transient block OOM."""
        from kubeflow_rm_tpu_torch.models import paging

        pool, BS = self.pool, self.block_size
        chain = req.chain
        Tp, budget = len(req.prompt), req.max_new_tokens
        nchain = len(chain["keys"])
        needed = -(-(Tp + budget) // BS)
        fresh = pool.alloc(needed)
        if fresh is None:
            return None
        cache = self.cache
        paging.seat_chunks(cache, fresh[:nchain], chain)
        if needed > nchain:
            # decode-budget blocks past the chain may be recycled: wipe
            # their positions so the gathered strip never shows a stale
            # row (what paged_install guarantees on the prefill path)
            cache.positions[self._tensor(fresh[nchain:], torch.long)] = \
                _UNFILLED
        final_row = [paging.NULL_BLOCK] * (self.slot_len // BS)
        final_row[:needed] = fresh
        cache.block_tables[i] = self._tensor(final_row, torch.long)
        cache.write_idx[i] = Tp
        cache.pos_next[i] = Tp
        if self.prefix_cache:
            parent = None
            for j, key in enumerate(chain["keys"]):
                pool.register(key, fresh[j], parent=parent,
                              covered=chain["covers"][j])
                parent = key
        self._slot_blocks[i] = fresh
        self.prefix_hit_tokens += Tp   # the whole prompt arrived cached
        self.prompt_tokens += Tp
        self.chain_installs += 1
        return paging.from_host(chain["last_logits"], torch.float32,
                                self.device)

    @torch.no_grad()
    def prefill_chain(self, prompt) -> dict | None:
        """Prefill-replica entry point: compute the full prompt's KV
        chain into the local pool (adopting any cached prefix), register
        it, and export it with the last real token's logits — so a
        decode replica can ``install_chain`` it without prefilling. No
        decode slot is touched; the chain stays behind as retained
        (ref-0) prefix cache. Returns ``None`` on transient block OOM."""
        from kubeflow_rm_tpu_torch.models import paging

        if not self.paged:
            raise ValueError("prefill_chain requires the paged engine")
        prompt = [int(t) for t in prompt]
        Tp = len(prompt)
        if Tp == 0:
            raise ValueError("empty prompt")
        if _bucket_len(Tp) > self.slot_len:
            raise ValueError(
                f"prompt bucket {_bucket_len(Tp)} > slot_len "
                f"{self.slot_len}")
        BS = self.block_size
        # the prompt only: no decode budget
        plan = self._plan(prompt, 0, paging.prefix_keys(prompt, BS))
        if plan is None:
            return None
        shared_full, needed = plan["shared_full"], plan["needed"]
        last, tk, tv, tpos = self._prefill_suffix(plan, prompt)
        # carve owned chunks into their blocks WITHOUT seating any slot
        # table — a prefill replica never decodes
        L, maxb = self.cache.k.shape[0], self.slot_len // BS
        idx = self._tensor(plan["fresh"], torch.long)
        ck = tk[:, 0].reshape(L, maxb, BS, *tk.shape[3:])
        cv = tv[:, 0].reshape(L, maxb, BS, *tv.shape[3:])
        self.cache.k[:, idx] = ck[:, shared_full:needed]
        self.cache.v[:, idx] = cv[:, shared_full:needed]
        self.cache.positions[idx] = tpos[0].reshape(maxb, BS)[
            shared_full:needed]
        if plan["fork"]:
            self.pool.decref([plan["chain"][shared_full]])
        self._register(plan["keys"], plan["final_row"])
        out = paging.export_chain(self.cache, self.pool, prompt)
        # logits keep float32: install-side sampling must see the exact
        # values solo prefill would produce
        out["last_logits"] = last.float().cpu().numpy()
        out["nbytes"] += out["last_logits"].nbytes
        # release: everything drops to ref 0 — registered blocks are
        # retained as prefix cache until evicted
        self.pool.decref(plan["shared"])
        self.pool.decref(plan["fresh"])
        self.prefills += 1
        self.chains_exported += 1
        self.prefix_hit_tokens += plan["n_hit"]
        self.prompt_tokens += Tp
        return out

    def _retire(self, i: int) -> None:
        if self.paged and self._slot_blocks[i] is not None:
            self.pool.decref(self._slot_blocks[i])
        self._slot_blocks[i] = None
        self._slot_req[i] = None
        self._last[i] = None

    def _sample(self) -> dict[int, int]:
        """Next token of every live slot. Greedy slots are decided by one
        argmax over their stacked logits (one sync for all of them);
        sampled slots draw from their own generators."""
        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        greedy = [i for i in live if self._slot_req[i].temperature <= 0]
        picks = {}
        if greedy:
            rows = torch.stack([self._last[i] for i in greedy])
            picks.update(zip(greedy, rows.argmax(-1).tolist()))
        for i in live:
            req = self._slot_req[i]
            if req.temperature > 0:
                picks[i] = _pick_row(self._last[i], req.generator,
                                     temperature=req.temperature,
                                     top_k=req.top_k)
        return picks

    @torch.no_grad()
    def step(self) -> list[EngineRequest]:
        """Admit, sample, retire, decode — one token boundary. Returns
        the requests that finished at this boundary."""
        from kubeflow_rm_tpu_torch.models import paging

        self._admit()
        finished, self._spec_finished = self._spec_finished, []
        picks = self._sample()
        tokens = [0] * self.slots
        active = [False] * self.slots
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            nxt = picks[i]
            req.tokens.append(nxt)
            hit_eos = req.eos_id is not None and nxt == req.eos_id
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                req.finished_step = self.decode_steps
                finished.append(req)
                self._retire(i)
                self.finished_total += 1
            else:
                tokens[i] = nxt
                active[i] = True
        n_active = sum(active)
        if n_active:
            decode = (paging.paged_decode_step if self.paged
                      else slot_decode_step)
            tok_t = self._tensor(tokens)
            act_t = self._tensor(active, torch.bool)
            _jit_sentinel.note("engine.decode_step", tok_t, act_t)
            with _hostsync.region("engine.decode"):
                last, self.cache = decode(self.params, self.cfg, self.cache,
                                          tok_t, act_t)
            for i in range(self.slots):
                if active[i]:
                    self._last[i] = last[i]
            self.decode_steps += 1
            self.occupancy_sum += n_active
        return finished

    def run(self) -> list[EngineRequest]:
        """Drive ``step`` until every queued and live request retires."""
        out: list[EngineRequest] = []
        while (self.queue_depth
               or any(r is not None for r in self._slot_req)):
            out.extend(self.step())
        return out

    # -- observability -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def queue_depth_by_class(self) -> dict:
        return {c: len(self._queues[c]) for c in SLO_CLASSES}

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def stats(self) -> dict:
        steps = self.decode_steps
        out = {
            "slots": self.slots,
            "slot_len": self.slot_len,
            "paged": self.paged,
            "active_slots": self.active_slots,
            "queue_depth": self.queue_depth,
            "queue_depth_by_class": self.queue_depth_by_class,
            "decode_steps": steps,
            "prefills": self.prefills,
            "admitted_total": self.admitted_total,
            "admitted_by_class": dict(self.admitted_by_class),
            "finished_total": self.finished_total,
            "batch_occupancy": (self.occupancy_sum / (steps * self.slots)
                                if steps else 0.0),
            "speculative_requests": self.speculative_requests,
            "speculative_model_calls": self.speculative_model_calls,
        }
        if self.paged:
            out.update(self.pool.stats())
            out["prefix_hit_tokens"] = self.prefix_hit_tokens
            out["prompt_tokens"] = self.prompt_tokens
            out["prefix_hit_ratio"] = (
                self.prefix_hit_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0)
            out["chain_installs"] = self.chain_installs
            out["chains_exported"] = self.chains_exported
            out["chains_adopted"] = self.chains_adopted
        return out
