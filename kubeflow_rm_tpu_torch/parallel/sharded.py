"""The model's view of a mesh: how one rank computes a block on its local
shards (the port's counterpart of what GSPMD derives from the JAX
package's sharding rules, ``parallel.sharding``).

JAX annotates global arrays and XLA inserts the collectives. Here each
rank holds its slices (``sharding.shard_params``) and ``MeshView`` runs
the collectives of ``parallel.collectives`` at the points GSPMD would:

- **fsdp**: every weight is all-gathered over ``fsdp`` where the block
  uses it, inside the remat'd block (a recompute gathers again); the
  gather's backward reduce-scatters the weight's gradient.
- **tp** (Megatron): the block runs on local heads ``H/tp``,
  ``KVH/tp``. The input of every column-parallel product (wq/wk/wv,
  w_gate/w_up, and a LoRA ``b``) passes through ``copy_to_group`` (*f*:
  its backward sums the partial input gradients), and wo/w_down end in
  an ``all_reduce`` (*g*). A LoRA ``a`` of a row-parallel weight is
  split to the local rows (``split_to_group``) and its ``b``, whose
  output columns the rules put on ``tp``, is gathered
  (``all_gather``: each rank's product is a partial sum, so the
  backward reduce-scatters). Where tp does not divide the KV heads
  (Llama-3-8B's 8 at tp = 16), the K/V heads are repeated by the least
  ``kv_rep`` that makes them divide (as Ulysses does over ``sp``): the
  rules still put a fraction of a head's wk/wv columns on a rank, so
  those two weights (and their LoRA ``b``) are gathered over tp in the
  block, as fsdp gathers, and each rank keeps the whole repeated heads
  its query heads read. tp must divide the query heads: a split query
  head is no whole-head plan.
- **embedding and head**: the vocabulary is on ``tp``. The embedding is
  a masked local lookup plus an ``all_reduce``; the head computes this
  rank's vocabulary columns, which the training loss reduces in place
  (``ops.losses.softmax_cross_entropy(..., vocab_group=)``) and decode
  returns as JAX's ``make_decode_step`` does; ``forward``'s public
  logits gather them over ``tp`` (``gather_from_group``).
- **pp**: each rank holds its stage's ``L/pp`` layers of every stacked
  leaf; ``forward`` on such a mesh runs the GPipe schedule
  (``parallel.pipeline``), and a decode step passes its activation from
  stage to stage (``stage_handoff``).
- **ep** (Mixtral): each ``ep`` rank holds ``E/ep`` experts. The tokens
  are replicated over ``ep``; the router's expert columns are gathered,
  so every rank routes alike on the full float32 logits, dispatches to
  its local experts only, and the combine ends in an ``all_reduce``
  over ``ep``. Routing is global over the data axes, as JAX's
  ``cumsum`` over the global token axis is: capacity comes from the
  global token count and slot priority from the global (slot, token)
  order (``MeshView.moe_route``, the hooks of ``moe.moe_ffn``).
- **sp**: ``cfg.attention_backend`` "ring" / "ulysses" dispatch to
  ``ring_attention`` / ``ulysses_attention`` on the local chunks;
  "auto" all-gathers K/V over ``sp`` and attends with global
  positions, as GSPMD would.

A quantized (frozen) weight is gathered whole over every axis the
compute does not keep local, dequantized, and sliced to the local
columns or rows where its stored sharding fell back
(``sharding.effective_spec``).
"""

from __future__ import annotations

import math

import torch

from kubeflow_rm_tpu_torch.models.lora import LORA_A, LORA_B
from kubeflow_rm_tpu_torch.models.quantize import is_quantized, maybe_dequant
from kubeflow_rm_tpu_torch.models.remat import project
from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention
from kubeflow_rm_tpu_torch.parallel.collectives import (
    all_gather, all_reduce, broadcast, copy_to_group, gather_from_group,
    split_to_group,
)
from kubeflow_rm_tpu_torch.parallel.mesh import (
    AXES, axis_group, axis_index, axis_size,
)
from kubeflow_rm_tpu_torch.parallel.sharding import (
    flat_specs, rule_spec,
)

#: row-parallel projections: contraction dim on tp, output all-reduced
ROW_PARALLEL = ("wo", "w_down")
#: the process-group axes a batch is split over
DATA_AXES = ("dp", "fsdp", "sp")
ROW_AXES = ("dp", "fsdp")


def kv_repeat(cfg, tp: int) -> int:
    """The least factor r that makes tp divide ``n_kv_heads · r`` (1
    where tp divides the K/V heads); H divides KVH·r = lcm(KVH, tp)
    whenever tp divides H."""
    return tp // math.gcd(cfg.n_kv_heads, tp)


def kv_heads_local(cfg, tp: int) -> int:
    """A tp rank's K/V heads: the repeated ones split over tp."""
    return cfg.n_kv_heads * kv_repeat(cfg, tp) // tp


class MeshView:
    """One rank's plan for a forward on ``mesh`` of the local tree
    ``params`` (built per call; the groups are cached on the mesh)."""

    def __init__(self, mesh, cfg, params: dict):
        sizes = {a: axis_size(mesh, a) for a in AXES}
        tp = sizes["tp"]
        H = cfg.n_heads
        if H % tp:
            raise ValueError(
                f"tp ({tp}) must divide n_heads ({H}): each rank computes "
                "whole query heads")
        if cfg.n_layers % sizes["pp"]:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                             f"pp={sizes['pp']}")
        moe = getattr(cfg, "moe", None)
        if moe is not None and moe.n_experts % sizes["ep"]:
            raise ValueError(f"ep ({sizes['ep']}) must divide n_experts "
                             f"({moe.n_experts})")
        self.mesh, self.sizes = mesh, sizes
        self.tp, self.sp, self.pp = tp, sizes["sp"], sizes["pp"]
        #: K/V heads repeated this many times so that tp divides them
        self.kv_rep = kv_repeat(cfg, tp)
        self.stage = axis_index(mesh, "pp")
        self.g_fsdp = axis_group(mesh, "fsdp")
        self.g_tp = axis_group(mesh, "tp")
        self.g_ep = axis_group(mesh, "ep")
        self.g_sp = axis_group(mesh, "sp")
        self.g_pp = axis_group(mesh, "pp")
        self.g_data = axis_group(mesh, DATA_AXES)
        self.specs = flat_specs(params)

    # ---- weights --------------------------------------------------------

    def _spec(self, path: str, t: torch.Tensor, layer: bool) -> tuple:
        """The spec of ``t``, one layer of the stacked ``path`` (``layer``)
        or a whole top-level leaf."""
        spec = self.specs.get(path)
        if spec is None:                 # a leaf the view was not built on
            spec = rule_spec(path, t.dim() + int(layer))
        return spec[1:] if layer else spec

    def _gather_fsdp(self, t: torch.Tensor, spec) -> torch.Tensor:
        for d, ax in enumerate(spec):
            if ax == "fsdp":
                t = all_gather(t, self.g_fsdp, d)
        return t

    def weight(self, path: str, leaf, dtype, *, layer: bool = True):
        """The compute-ready weight of ``path`` in ``dtype``: gathered
        over ``fsdp``, local on ``tp``/``ep`` as the rule puts them."""
        if not is_quantized(leaf):
            if self.sizes["fsdp"] == 1:
                return leaf.to(dtype)
            return self._gather_fsdp(
                leaf, self._spec(path, leaf, layer)).to(dtype)
        parts, main = {}, None
        for part, t in leaf.items():
            spec = self._spec(f"{path}/{part}", t, layer)
            rule = rule_spec(f"{path}/{part}", t.dim() + int(layer))
            rule = rule[1:] if layer else rule
            for d, ax in enumerate(spec):
                if ax is not None and not (ax in ("tp", "ep")
                                           and rule[d] == ax):
                    t = all_gather(t, axis_group(self.mesh, ax), d)
            parts[part] = t
            if part != "s":
                main = (part, spec)
        w = maybe_dequant(parts, dtype)
        # where the stored sharding fell back off a tp/ep dim that the
        # compute keeps local, the weight is whole there: slice it
        base = rule_spec(path, w.dim() + int(layer))
        base = base[1:] if layer else base
        part, spec = main
        for d, ax in enumerate(base):
            if ax not in ("tp", "ep"):
                continue
            pd = d + 1 if (part != "q" and d == w.dim() - 1) else d
            if spec[pd] != ax:
                w = split_to_group(w, axis_group(self.mesh, ax), d)
        return w

    # ---- projections ----------------------------------------------------

    def projector(self, cfg, layer: dict):
        """``proj(name, t)`` for one layer: the tp-parallel counterpart of
        ``lora_proj`` (base product plus the factored adapter). With one
        tp rank *f* and *g* are the identity, and the projections call
        neither (a decode step meets hundreds)."""
        dt = cfg.dtype
        split = self.tp > 1
        entered = {}

        def enter(t):
            # one f per input: the column products that read the same
            # activation share it (and its backward all-reduce)
            if not split:
                return t
            if entered.get("src") is not t:
                entered["src"], entered["f"] = t, copy_to_group(t, self.g_tp)
            return entered["f"]

        def proj(name, t):
            w = self.weight(f"blocks/{name}", layer[name], dt)
            a = layer.get(name + LORA_A)
            if name in ROW_PARALLEL:
                out = project(t, w, name)
                if a is not None:
                    a = self.weight(f"blocks/{name}{LORA_A}", a, a.dtype)
                    a = split_to_group(a, self.g_tp, 0)
                    b = all_gather(layer[name + LORA_B], self.g_tp, 1)
                    out = out + (t @ a.to(dt)) @ b.to(dt) * (
                        cfg.lora_alpha / a.shape[-1])
                return all_reduce(out, self.g_tp) if split else out
            whole = name in ("wk", "wv") and self.kv_rep > 1
            if whole:
                # a fraction of a head's columns per rank: gather them
                w = all_gather(w, self.g_tp, -1)
            out = project(enter(t), w, name)
            if a is not None:
                a = self.weight(f"blocks/{name}{LORA_A}", a, a.dtype)
                u = copy_to_group(t @ a.to(dt), self.g_tp)
                b = layer[name + LORA_B]
                if whole:
                    b = all_gather(b, self.g_tp, -1)
                out = out + u @ b.to(dt) * (cfg.lora_alpha / a.shape[-1])
            return self._own_kv_heads(cfg, out) if whole else out

        return proj

    def local_heads(self, cfg) -> tuple[int, int]:
        """This rank's query heads and (repeated) K/V heads."""
        return cfg.n_heads // self.tp, kv_heads_local(cfg, self.tp)

    def _own_kv_heads(self, cfg, out: torch.Tensor) -> torch.Tensor:
        """This rank's repeated K/V heads from the (..., KVH·hd) output
        of the whole K or V projection: virtual head j of the rank's
        ``n`` is real head ``(i·n + j) // kv_rep``."""
        KVH, hd = cfg.n_kv_heads, cfg.head_dim
        n = KVH * self.kv_rep // self.tp
        first = axis_index(self.mesh, "tp") * n
        own = torch.arange(first, first + n, device=out.device) // self.kv_rep
        heads = out.reshape(*out.shape[:-1], KVH, hd).index_select(-2, own)
        return heads.reshape(*out.shape[:-1], n * hd)

    # ---- embedding and head ---------------------------------------------

    def embed(self, params: dict, tokens: torch.Tensor, cfg):
        """Masked lookup in the local vocabulary rows, summed over tp."""
        table = self.weight("embed/tokens", params["embed"]["tokens"],
                            params["embed"]["tokens"].dtype, layer=False)
        V_loc = table.shape[0]
        ids = tokens.long() - axis_index(self.mesh, "tp") * V_loc
        inside = (ids >= 0) & (ids < V_loc)
        rows = table[ids.clamp(0, V_loc - 1)].to(cfg.dtype)
        x = torch.where(inside[..., None], rows, rows.new_zeros(()))
        return all_reduce(x, self.g_tp)

    def head(self, params: dict, x: torch.Tensor, cfg, *,
             local_vocab: bool = False):
        """Final norm and the local vocabulary columns (float32 logits):
        this rank's ``V/tp`` columns with ``local_vocab``, else gathered
        over tp."""
        from kubeflow_rm_tpu_torch.ops.norms import rms_norm

        x = rms_norm(x, params["out_norm"], cfg.norm_eps)
        w = self.weight("lm_head", params["lm_head"], cfg.dtype, layer=False)
        logits = (copy_to_group(x, self.g_tp) @ w).float()
        if local_vocab:
            return logits
        return gather_from_group(logits, self.g_tp, -1)

    def pick(self, last: torch.Tensor, generator, *, temperature: float,
             top_k: int | None, sampler) -> torch.Tensor:
        """The next token of each row from this rank's vocabulary
        columns ``last`` (B, V/tp). Greedy: each rank's (maximum, first
        index) pair, all-gathered, and the largest maximum's lowest
        index (``jnp.argmax``'s tie rule: ranks hold ascending columns).
        Sampling gathers the row of logits (every tp rank must draw the
        same token) and runs ``sampler``, the one-device pick."""
        if self.tp == 1:
            return sampler(last, generator, temperature=temperature,
                           top_k=top_k)
        if temperature > 0:
            return sampler(gather_from_group(last, self.g_tp, -1),
                           generator, temperature=temperature, top_k=top_k)
        idx = last.argmax(dim=-1)
        val = last.gather(-1, idx[:, None])[:, 0]
        idx = idx + axis_index(self.mesh, "tp") * last.shape[-1]
        vals = all_gather(val[None], self.g_tp, 0)            # (tp, B)
        idxs = all_gather(idx[None], self.g_tp, 0)
        first = (vals == vals.max(dim=0).values).int().argmax(dim=0)
        return idxs.gather(0, first[None])[0].to(torch.int32)

    # ---- pipeline stages --------------------------------------------------

    def stage_handoff(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Stage ``src``'s activation on every pp rank (a decode step's
        hand-off; no gradient)."""
        return broadcast(x, self.g_pp, src)

    # ---- attention --------------------------------------------------------

    def chunk_positions(self, B: int, T_loc: int, device) -> torch.Tensor:
        """Global positions of this rank's ``sp`` chunk."""
        from kubeflow_rm_tpu_torch.parallel.ring_attention import (
            local_positions,
        )

        return local_positions(self.mesh, B, T_loc, device)

    def attention(self, cfg, q, k, v, positions, segments, impl):
        """The block's attention on local heads (and, for sp > 1, local
        sequence chunks)."""
        if self.sp == 1:
            return dot_product_attention(
                q, k, v, causal=True, positions_q=positions,
                positions_kv=positions, segment_ids_q=segments,
                segment_ids_kv=segments, impl=impl)
        backend = cfg.attention_backend
        if backend == "ulysses":
            from kubeflow_rm_tpu_torch.parallel.ulysses import (
                ulysses_attention,
            )
            # without explicit positions the gathered sequence is in
            # natural order, where the local-index causal mask equals
            # the arange-position one: the flash kernel stays eligible
            return ulysses_attention(
                q, k, v, group=self.g_sp, causal=True,
                positions_q=positions, positions_kv=positions,
                segment_ids_q=segments, segment_ids_kv=segments, impl=impl)
        B, T_loc = q.shape[:2]
        pos = positions if positions is not None else self.chunk_positions(
            B, T_loc, q.device)
        if backend == "ring":
            from kubeflow_rm_tpu_torch.parallel.ring_attention import (
                ring_attention,
            )
            return ring_attention(q, k, v, group=self.g_sp, causal=True,
                                  positions_q=pos, positions_kv=pos,
                                  segment_ids_q=segments,
                                  segment_ids_kv=segments)
        # "auto": K/V gathered over sp, global positions (GSPMD's way)
        seg_kv = None if segments is None else all_gather(segments, self.g_sp, 1)
        return dot_product_attention(
            q, all_gather(k, self.g_sp, 1), all_gather(v, self.g_sp, 1),
            causal=True, positions_q=pos,
            positions_kv=all_gather(pos.contiguous(), self.g_sp, 1),
            segment_ids_q=segments, segment_ids_kv=seg_kv, impl=impl)

    # ---- mixture of experts ---------------------------------------------

    def moe_router(self, layer: dict) -> torch.Tensor:
        """The router with every expert's column (gathered over ep), so
        each rank routes alike on the full logits."""
        router = self.weight("blocks/router", layer["router"],
                             layer["router"].dtype)
        return gather_from_group(router, self.g_ep, 1)

    def moe_route(self, B: int, T: int) -> dict:
        """``moe.route``'s arguments for this rank's (B, T) tokens, ranked
        among every data rank's: JAX's ``cumsum`` runs over the global
        token axis, so capacity comes from the global token count and
        slot priority from the global (slot, token) order."""
        n_rows, n_sp = axis_size(self.mesh, ROW_AXES), self.sp

        def offsets(onehot):
            N, k, E = onehot.shape
            # a chunk is one row's sp block; chunks in global token order
            # are (row, sp block), rows over (dp, fsdp)
            per_row = onehot.reshape(B, T, k, E)
            within = torch.cumsum(per_row, dim=1) - 1
            counts = per_row.sum(1)                               # (B, k, E)
            every = all_gather(counts.contiguous(), self.g_data, 0)
            every = every.reshape(n_rows, n_sp, B, k, E).permute(
                0, 2, 1, 3, 4).reshape(-1, k, E)
            earlier_chunks = torch.cumsum(every, dim=0) - every
            total = every.sum(0)                                  # (k, E)
            earlier_slots = torch.cumsum(total, dim=0) - total
            chunk = ((axis_index(self.mesh, ROW_AXES) * B
                      + torch.arange(B, device=onehot.device)) * n_sp
                     + axis_index(self.mesh, "sp"))
            pos = within + earlier_chunks[chunk][:, None] + earlier_slots
            return pos.reshape(N, k, E)

        return {"offsets": offsets, "n_global": B * T * n_rows * n_sp,
                "reduce": lambda t: all_reduce(t, self.g_data)}

    def moe_local(self, dispatch, combine, xf):
        """This rank's experts' dispatch and combine columns, and the
        tokens, each entering the ep group (*f*: the ranks' partial
        gradients sum)."""
        E_loc = dispatch.shape[1] // self.sizes["ep"]
        i = axis_index(self.mesh, "ep")
        mine = slice(i * E_loc, (i + 1) * E_loc)
        return (dispatch[:, mine],
                copy_to_group(combine, self.g_ep)[:, mine],
                copy_to_group(xf, self.g_ep))
