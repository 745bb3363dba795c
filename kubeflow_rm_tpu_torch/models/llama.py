"""Llama-family decoder (counterpart of
``kubeflow_rm_tpu/models/llama.py``).

Parameters are a plain dict of tensors in the JAX package's layout
(``param_spec_shapes``): weights stay ``(in, out)`` so a projection is
``x @ w``, and the per-layer weights stay stacked on a leading layer
axis ``(L, ...)``. Where JAX scans over that axis, the port runs a
Python loop and indexes layer ``i`` as a view (no copy).

Compute follows the JAX rounding points: params are stored in
``param_dtype`` and cast to ``dtype`` at use (a no-op when the two are
equal, as for bf16 serving), projections run in ``dtype``, RMSNorm and
RoPE work in float32 internally, and the logits are ``x @ lm_head`` in
``dtype`` cast to float32.

Rematerialization (``LlamaConfig.remat``/``remat_policy``) wraps each
block in ``torch.utils.checkpoint`` with the selective-checkpoint
policies of ``models.remat``, which save what JAX's ``_remat_policy``
saves (``llama.py:162-180``). The forward names its parts as spans
(``utils.profiling.annotate``): ``embed``, each block's ``block.attn``
and ``block.mlp``, and ``head``.

On a mesh (``forward(..., mesh=)``) each rank runs the same blocks on its
local shards through ``parallel.sharded.MeshView``: weights gathered over
fsdp, heads split over tp, the sequence over sp (ring or Ulysses
attention by ``cfg.attention_backend``), the layer stack over pp (the
GPipe schedule of ``parallel.pipeline``, whose stage body is this
module's block and whose ends are ``_prologue`` and ``_epilogue``). ``mesh=None`` is the one-device
path, untouched: no collective, no process group.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_rm_tpu_torch.models.lora import lora_proj
from kubeflow_rm_tpu_torch.models.quantize import maybe_dequant
from kubeflow_rm_tpu_torch.models.remat import (
    checkpoint_name, remat_context_fn,
)
from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention
from kubeflow_rm_tpu_torch.ops.norms import rms_norm
from kubeflow_rm_tpu_torch.ops.rope import apply_rope, rope_angles
from kubeflow_rm_tpu_torch.utils.profiling import annotate


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # "dots": save every projection output (fastest backward, the most
    # activation memory); "full": save only the block inputs and
    # recompute the block; "attn"/"mlp"/"attn+mlp": save the named
    # activations only (_NAME_POLICIES)
    remat_policy: str = "dots"
    # LoRA scaling (alpha/rank) for adapter-carrying params
    lora_alpha: float = 16.0
    # attention under a mesh with sp > 1: "ring", "ulysses", or "auto"
    # (K/V gathered over sp); one device ignores it
    attention_backend: str = "auto"

    def __post_init__(self):
        if self.attention_backend not in ("auto", "ring", "ulysses"):
            raise ValueError("attention_backend must be auto/ring/ulysses, "
                             f"got {self.attention_backend!r}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # ---- presets (the JAX package's, same widths) ---------------------
    @staticmethod
    def llama2_7b(**overrides) -> "LlamaConfig":
        return replace(LlamaConfig(), **overrides)

    @staticmethod
    def llama2_13b(**overrides) -> "LlamaConfig":
        return replace(
            LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                        hidden_dim=13824),
            **overrides,
        )

    @staticmethod
    def llama3_8b(**overrides) -> "LlamaConfig":
        return replace(
            LlamaConfig(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                        n_kv_heads=8, hidden_dim=14336, rope_theta=500000.0,
                        max_seq_len=8192),
            **overrides,
        )

    @staticmethod
    def bench_1b(**overrides) -> "LlamaConfig":
        return replace(
            LlamaConfig(dim=2048, n_layers=20, n_heads=16, n_kv_heads=16,
                        hidden_dim=5632, max_seq_len=2048),
            **overrides,
        )

    @staticmethod
    def bench_2b(**overrides) -> "LlamaConfig":
        return replace(
            LlamaConfig(dim=2560, n_layers=24, n_heads=20, n_kv_heads=20,
                        hidden_dim=6912, max_seq_len=2048),
            **overrides,
        )

    @staticmethod
    def bench_2_7b(**overrides) -> "LlamaConfig":
        return replace(
            LlamaConfig(dim=3072, n_layers=22, n_heads=24, n_kv_heads=24,
                        hidden_dim=8192, max_seq_len=2048),
            **overrides,
        )

    @staticmethod
    def bench_3b(**overrides) -> "LlamaConfig":
        return replace(
            LlamaConfig(dim=3072, n_layers=26, n_heads=24, n_kv_heads=24,
                        hidden_dim=8192, max_seq_len=2048),
            **overrides,
        )

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Test-sized config: runs in milliseconds on a CPU."""
        return replace(
            LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                        dtype=torch.float32),
            **overrides,
        )


PRESETS = ("llama2_7b", "llama2_13b", "llama3_8b", "bench_1b", "bench_2b",
           "bench_2_7b", "bench_3b", "tiny")


def param_spec_shapes(cfg: LlamaConfig) -> dict:
    """Shapes of the parameter dict (layer-stacked), as in JAX."""
    L, D, V = cfg.n_layers, cfg.dim, cfg.vocab_size
    H, KVH, hd, F_ = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim
    return {
        "embed": {"tokens": (V, D)},
        "blocks": {
            "attn_norm": (L, D),
            "wq": (L, D, H * hd),
            "wk": (L, D, KVH * hd),
            "wv": (L, D, KVH * hd),
            "wo": (L, H * hd, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, F_),
            "w_up": (L, D, F_),
            "w_down": (L, F_, D),
        },
        "out_norm": (D,),
        "lm_head": (D, V),
    }


def init_leaf(cfg: LlamaConfig, name: str, shape, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """Init rule for one named leaf (JAX ``init_leaf``): norms are ones,
    residual-writing projections N(0, 1)·0.02/sqrt(2·L), the rest
    N(0, 1)·0.02; drawn in float32, stored in ``param_dtype``."""
    if "norm" in name:
        return torch.ones(shape, dtype=cfg.param_dtype, device=device)
    scale = 0.02
    if name in ("wo", "w_down", "moe_down"):
        scale = 0.02 / (2.0 * cfg.n_layers) ** 0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(cfg.param_dtype)


def _by_layer(n_layers: int, make, layers: range | None = None):
    """Stack ``make(i, keep)`` (a tensor or a dict of tensors) over the
    ``layers`` (default all) into preallocated ``(len(layers), ...)``
    tensors, one layer's result alive at a time. ``make`` runs for every
    layer (``keep`` False outside ``layers``: it draws, so the generator
    advances as for the whole stack, and returns nothing)."""
    layers = range(n_layers) if layers is None else layers
    out, is_dict = None, False
    for i in range(n_layers):
        part = make(i, i in layers)
        if i not in layers:
            continue
        is_dict = isinstance(part, dict)
        parts = part if is_dict else {"": part}
        if out is None:
            out = {k: t.new_empty((len(layers), *t.shape))
                   for k, t in parts.items()}
        for k, t in parts.items():
            out[k][i - layers.start] = t
        del part, parts
    return out if is_dict else out[""]


def init_tree(cfg: LlamaConfig, shapes: dict, generator: torch.Generator,
              device: torch.device, transform=None,
              layers: range | None = None) -> dict:
    """Random leaves for the shape tree ``shapes`` by ``init_leaf``'s
    rules, drawn leaf by leaf from ``generator`` and every ``blocks``
    leaf one layer at a time. ``transform(path, tensor)``, if given,
    maps each draw (one layer of a stacked leaf, or a whole top-level
    leaf; ``path`` as ``"blocks/wq"``, ``"embed/tokens"``) before the
    next is drawn: the quantizer of ``quantize.init_params_quantized``,
    the per-rank slicer of ``sharding.Sharder``. ``layers`` (default
    all) keeps only those layers of every stacked leaf, a pp stage's:
    the others are drawn, to keep the generator in step, and dropped at
    once."""
    fn = transform or (lambda path, t: t)

    def leaf(path, shape, keep=True):
        name = path.rsplit("/", 1)[-1]
        t = init_leaf(cfg, name, shape, generator, device)
        return fn(path, t) if keep else None

    out = {}
    for name, s in shapes.items():
        if name == "blocks":
            out[name] = {k: _by_layer(shp[0], lambda i, keep, k=k, shp=shp:
                                      leaf(f"blocks/{k}", shp[1:], keep),
                                      layers)
                         for k, shp in s.items()}
        elif isinstance(s, dict):
            out[name] = {k: leaf(f"{name}/{k}", shp) for k, shp in s.items()}
        else:
            out[name] = leaf(name, s)
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: str | torch.device | None = None, *,
                transform=None, layers: range | None = None) -> dict:
    """Random parameters matching ``param_spec_shapes``, drawn from
    ``generator`` (which must live on ``device``) by ``init_tree``: one
    layer of a stacked leaf at a time, each draw passed through
    ``transform``, the stacked leaves keeping ``layers``. The draws are
    not JAX's: parity tests carry JAX's weights over with
    ``params.from_numpy_params`` instead."""
    from kubeflow_rm_tpu_torch.device import default_device

    return init_tree(cfg, param_spec_shapes(cfg), generator,
                     default_device(device), transform, layers)


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s weights as views into the stacked tensors (a
    quantized leaf is sliced array by array). Decode and other paths that
    record no gradient; a training forward takes ``layer_slices``."""
    return {name: ({k: t[i] for k, t in w.items()} if isinstance(w, dict)
                   else w[i])
            for name, w in blocks.items()}


class _LeafGrad:
    """The gradient of one stacked leaf, filled a layer at a time by
    ``_StackedSlice`` in one backward pass."""

    __slots__ = ("shape", "n", "pending", "buf")

    def __init__(self, leaf: torch.Tensor):
        self.shape = leaf.shape
        self.n = self.pending = leaf.shape[0]
        self.buf = None

    def check_complete(self) -> None:
        # queued at the first slice's backward, run when the pass ends
        if self.pending != self.n:
            pending, self.pending, self.buf = self.pending, self.n, None
            raise RuntimeError(
                f"{pending} of {self.n} layer slices of a stacked leaf "
                f"received no gradient: every slice taken by "
                f"layer_slices must be in the loss's graph")


class _StackedSlice(torch.autograd.Function):
    """Layer ``i`` of a stacked ``(L, ...)`` leaf, as the view ``leaf[i]``.

    ``leaf[i]``'s own backward (``select_backward``) is a zero-filled
    tensor of the whole leaf, one a layer, which autograd then adds into
    the leaf's gradient. Here each layer's backward copies its slice's
    gradient into one per-leaf buffer (``_LeafGrad``) in place and hands
    autograd nothing; the last of the L slices hands it the buffer. A
    backward pass holds the leaf's gradient plus one layer's slice, as
    JAX's scan, which writes each layer's gradient into the stacked
    result. The values are the sum's: each element has one non-zero term.
    """

    @staticmethod
    def forward(ctx, leaf, i, acc):
        ctx.i, ctx.acc = i, acc
        return leaf[i]

    @staticmethod
    def backward(ctx, g):
        acc = ctx.acc
        if acc.buf is None:
            acc.buf = g.new_empty(acc.shape)
            torch.autograd.Variable._execution_engine.queue_callback(
                acc.check_complete)
        acc.buf[ctx.i].copy_(g)
        acc.pending -= 1
        if acc.pending:
            return None, None, None
        buf, acc.buf, acc.pending = acc.buf, None, acc.n
        return buf, None, None


def layer_slices(blocks: dict) -> "_LayerSlices":
    """Every layer's weights of the stacked tree ``blocks``, for a forward
    that uses each layer once or more, all in one backward pass. Where
    autograd records, a leaf that requires grad is sliced by
    ``_StackedSlice`` (its gradient is built in place, a layer at a
    time); any other leaf, as ``layer_params``, by plain views.

    A layer is sliced when it is first read (``layers[i]``, or as the
    iteration reaches it) and kept for later reads: sliced just before
    its block, its backward node runs as soon as that block's backward
    is done, while slicing every layer up front would hold every layer's
    gradient in pieces until the backward's end (autograd runs the ready
    node it recorded last first)."""
    return _LayerSlices(blocks)


class _LayerSlices:
    """The sequence ``layer_slices`` returns."""

    def __init__(self, blocks: dict):
        self._blocks = blocks
        self._n = stacked_layers(blocks)
        self._take = None
        self._layers: dict[int, dict] = {}

    def _slicer(self, t):
        if not (t.requires_grad and torch.is_grad_enabled()):
            return t.__getitem__
        acc = _LeafGrad(t)
        return lambda i: _StackedSlice.apply(t, i, acc)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict:
        if not 0 <= i < self._n:
            raise IndexError(i)
        if i not in self._layers:
            if self._take is None:
                self._take = {
                    name: ({k: self._slicer(t) for k, t in w.items()}
                           if isinstance(w, dict) else self._slicer(w))
                    for name, w in self._blocks.items()}
            self._layers[i] = {
                name: ({k: f(i) for k, f in w.items()}
                       if isinstance(w, dict) else w(i))
                for name, w in self._take.items()}
        return self._layers[i]

    def __iter__(self):
        return (self[i] for i in range(self._n))


def _projector(cfg: LlamaConfig, layer, view):
    """``proj(name, t)`` of one layer: ``lora_proj`` on one device, the
    tp-parallel projection of ``view`` on a mesh."""
    if view is not None:
        return view.projector(cfg, layer)

    def proj(name, t):
        return lora_proj(layer, name, t, alpha=cfg.lora_alpha,
                         dtype=cfg.dtype)

    return proj


def _attention_half(cfg: LlamaConfig, x, layer, cos, sin, positions,
                    segments, impl, view=None):
    """Pre-norm attention + residual. x: (B, T, D) in compute dtype. On
    a mesh (``view``) the heads are this rank's ``H/tp``."""
    B, T, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if view is not None:
        H, KVH = view.local_heads(cfg)
    with annotate("block.attn"):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        proj = _projector(cfg, layer, view)
        q = checkpoint_name(apply_rope(
            proj("wq", h).reshape(B, T, H, hd), cos, sin), "q_rope")
        k = checkpoint_name(apply_rope(
            proj("wk", h).reshape(B, T, KVH, hd), cos, sin), "k_rope")
        v = checkpoint_name(proj("wv", h).reshape(B, T, KVH, hd), "v_proj")
        if view is None:
            attn = dot_product_attention(
                q, k, v, causal=True, positions_q=positions,
                positions_kv=positions, segment_ids_q=segments,
                segment_ids_kv=segments, impl=impl)
        else:
            attn = view.attention(cfg, q, k, v, positions, segments, impl)
        attn = checkpoint_name(attn, "attn_out")
        return x + proj("wo", attn.reshape(B, T, H * hd))


def _mlp(cfg: LlamaConfig, layer, h, view=None):
    """Dense SwiGLU FFN."""
    proj = _projector(cfg, layer, view)
    gate = checkpoint_name(proj("w_gate", h), "mlp_gate")
    up = checkpoint_name(proj("w_up", h), "mlp_up")
    return proj("w_down", F.silu(gate) * up)


def _block(cfg: LlamaConfig, x, layer, cos, sin, positions, segments, impl,
           view=None):
    """One transformer block (attention + dense SwiGLU MLP)."""
    x = _attention_half(cfg, x, layer, cos, sin, positions, segments, impl,
                        view)
    with annotate("block.mlp"):
        return x + _mlp(cfg, layer,
                        rms_norm(x, layer["mlp_norm"], cfg.norm_eps), view)


def embed(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, view=None):
    """Gather the (B, T, D) rows first, then cast — never a compute-dtype
    copy of the whole (V, D) table. The embedding is never quantized."""
    if view is not None:
        return view.embed(params, tokens, cfg)
    return params["embed"]["tokens"][tokens.long()].to(cfg.dtype)


def _epilogue(params: dict, x: torch.Tensor, cfg: LlamaConfig, view=None,
              *, local_vocab: bool = False):
    """Final norm, lm head (dequantized if quantized) in the compute
    dtype, float32 logits: the end of ``forward`` and of the pipeline
    (JAX's ``_epilogue``). On a mesh ``local_vocab`` keeps this rank's
    tp columns of the vocabulary."""
    with annotate("head"):
        if view is not None:
            return view.head(params, x, cfg, local_vocab=local_vocab)
        x = rms_norm(x, params["out_norm"], cfg.norm_eps)
        return (x @ maybe_dequant(params["lm_head"], cfg.dtype)).float()


def stacked_layers(blocks: dict) -> int:
    """The layers of the stacked tree ``blocks`` (a pp rank's share)."""
    leaf = next(iter(blocks.values()))
    if isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    positions: torch.Tensor | None = None,
    segments: torch.Tensor | None = None,
    *,
    packed: bool = False,
    impl: str = "auto",
    mesh=None,
    local_vocab: bool = False,
) -> torch.Tensor:
    """Causal LM forward pass: (B, T) token ids -> (B, T, vocab) float32
    logits.

    ``positions`` (B, T) default to arange; ``segments`` (B, T) restrict
    attention to equal segments. ``packed`` asserts the
    ``pack_documents`` layout (positions restart per document and rise
    within it): only then may the mask drop positions, which keeps the
    call on the flash kernel; without it explicit positions take the
    position-aware dense path. ``impl`` is passed to
    ``dot_product_attention`` ("auto", "flash" or "dense").

    Where autograd records and ``cfg.remat`` is set, each block runs
    under ``torch.utils.checkpoint`` with ``cfg.remat_policy``.

    ``mesh`` (a ``parallel.mesh.make_mesh`` mesh): ``params`` are this
    rank's shards (``parallel.sharding.shard_params``) and ``tokens``,
    ``positions``, ``segments`` its (dp, fsdp) rows and sp columns
    (``training.train.shard_batch``); the logits are this rank's rows and
    columns over the whole vocabulary, or with ``local_vocab`` its tp
    share of the vocabulary. A mesh with pp > 1 runs the GPipe schedule
    (``parallel.pipeline.pipeline_forward``, pp microbatches).
    """
    view = _mesh_view(mesh, cfg, params)
    if view is not None and view.pp > 1:
        from kubeflow_rm_tpu_torch.parallel.pipeline import pipeline_forward

        return pipeline_forward(params, tokens, cfg, mesh,
                                positions=positions, segments=segments,
                                packed=packed, impl=impl,
                                local_vocab=local_vocab)
    x, cos, sin, attn_positions = _prologue(params, tokens, cfg, positions,
                                            packed, view)
    blocks = params["blocks"]
    block = remat_block(partial(_block, cfg, view=view), cfg)
    for layer in layer_slices(blocks):
        x = block(x, layer, cos, sin, attn_positions, segments, impl)
    return _epilogue(params, x, cfg, view, local_vocab=local_vocab)


def _mesh_view(mesh, cfg, params):
    """``MeshView`` of ``mesh`` for this forward, or None (one device)."""
    if mesh is None:
        return None
    from kubeflow_rm_tpu_torch.parallel.sharded import MeshView

    return MeshView(mesh, cfg, params)


def _prologue(params, tokens, cfg, positions, packed, view=None):
    """Embedding and rotary angles of a forward, and the positions the
    attention mask sees: None (a plain causal mask, the flash path) unless
    explicit positions come without ``packed``. On a mesh the default
    positions are the global ones of this rank's sp chunk."""
    B, T = tokens.shape
    attn_positions = None if (positions is None or packed) else positions
    with annotate("embed"):
        if positions is None:
            if view is None:
                positions = torch.arange(T, dtype=torch.int32,
                                         device=tokens.device).expand(B, T)
            else:
                positions = view.chunk_positions(B, T, tokens.device)
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        return embed(params, tokens, cfg, view), cos, sin, attn_positions


def remat_block(block, cfg):
    """``block`` under ``torch.utils.checkpoint`` with ``cfg.remat_policy``
    where autograd records and ``cfg.remat`` is set, else ``block``."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return block
    # the block draws no random numbers: no RNG state to replay
    return partial(checkpoint, block, use_reentrant=False,
                   preserve_rng_state=False,
                   context_fn=remat_context_fn(cfg.remat_policy))


def forward_with_aux(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                     **kwargs):
    """``(logits, None)``: a dense model has no router aux loss
    (``models.forward_with_aux`` dispatches on the family)."""
    return forward(params, tokens, cfg, **kwargs), None
