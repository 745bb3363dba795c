"""Sharding rules: parameter tree -> partition spec tree (counterpart of
``kubeflow_rm_tpu/parallel/sharding.py``, whose rules these are, copied).

A spec is a tuple with one entry per dim of the leaf: ``None``
(replicated), an axis name, or a tuple of names (flattened, the first
major) — JAX's ``PartitionSpec`` as a plain tuple. JAX annotates global
arrays and lets GSPMD partition them; the port holds each rank's local
slice (``shard_params``) and its model gathers or reduces explicitly
(``models.llama.forward(..., mesh=)``). The rules, for the stacked-layer
Llama tree (leading axis = layer, on ``pp``):

- column-parallel weights (wq/wk/wv/w_gate/w_up): contraction dim on
  ``fsdp``, output dim on ``tp``;
- row-parallel weights (wo/w_down): ``tp`` on the contraction dim,
  output on ``fsdp``;
- embed: vocab on ``tp``, model dim on ``fsdp``; lm_head transposed
  likewise; norms replicated;
- MoE: the expert dim on ``ep``, the router's expert columns on ``ep``.

The batch is sharded over (dp, fsdp) jointly and over ``sp`` along the
sequence (``batch_pspec``).
"""

from __future__ import annotations

import warnings

import torch

from kubeflow_rm_tpu_torch.parallel.mesh import (
    axis_group, axis_index, axis_size,
)

# path (joined with '/') -> spec for the stacked-layer llama tree
_LLAMA_RULES = {
    "embed/tokens": ("tp", "fsdp"),
    "blocks/attn_norm": ("pp", None),
    "blocks/mlp_norm": ("pp", None),
    "blocks/wq": ("pp", "fsdp", "tp"),
    "blocks/wk": ("pp", "fsdp", "tp"),
    "blocks/wv": ("pp", "fsdp", "tp"),
    "blocks/wo": ("pp", "tp", "fsdp"),
    "blocks/w_gate": ("pp", "fsdp", "tp"),
    "blocks/w_up": ("pp", "fsdp", "tp"),
    "blocks/w_down": ("pp", "tp", "fsdp"),
    "out_norm": (None,),
    "lm_head": ("fsdp", "tp"),
    # MoE (mixtral family): expert dim on ep
    "blocks/router": ("pp", "fsdp", "ep"),
    "blocks/moe_gate": ("pp", "ep", "fsdp", "tp"),
    "blocks/moe_up": ("pp", "ep", "fsdp", "tp"),
    "blocks/moe_down": ("pp", "ep", "tp", "fsdp"),
}

#: the attribute ``shard_params`` sets on each local tensor: its
#: effective spec (``param_shardings``, which may differ from the rule
#: for a quantized leaf)
SPEC_ATTR = "mesh_spec"


def rule_spec(key: str, ndim: int) -> tuple:
    """The rule's spec of the leaf at path ``key`` with ``ndim`` dims."""
    # LoRA adapters: a carries the base weight's contract-dim sharding,
    # b its output-dim sharding; the rank axis stays replicated
    if key.endswith("_lora_a"):
        return ("pp", "fsdp", None)
    if key.endswith("_lora_b"):
        return ("pp", None, "tp")
    # int8 ({"q", "s"}): q shards like the base weight, the per-channel
    # scale keeps the output axis and replicates the collapsed one.
    # int4 ({"q4", "s"}) splits the contraction axis into (groups,
    # packed): the group axis inherits the contraction sharding, the
    # packed axis replicates; per-group scales have one extra
    # (singleton) axis and shard the same way
    # (the unpacked int4 ``q8g`` has q4's layout)
    if key.endswith(("/q", "/q4", "/q8g", "/s")):
        base = _LLAMA_RULES[key.rsplit("/", 1)[0]]
        if key.endswith("/q"):
            return base
        if key.endswith(("/q4", "/q8g")) or ndim == len(base) + 1:
            return (*base[:-1], None, base[-1])
        return tuple(None if i == len(base) - 2 else ax
                     for i, ax in enumerate(base))
    if key not in _LLAMA_RULES:
        raise KeyError(f"no sharding rule for param {key!r}")
    return _LLAMA_RULES[key]


def _map_paths(tree: dict, fn, prefix: str = "") -> dict:
    return {k: (_map_paths(v, fn, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v))
            for k, v in tree.items()}


def param_pspecs(params: dict) -> dict:
    """Spec tree for a Llama (or Mixtral) parameter tree."""
    return _map_paths(params, lambda key, t: rule_spec(key, t.dim()))


def _size(mesh, ax) -> int:
    return 1 if ax is None else axis_size(mesh, ax)


def effective_spec(key: str, shape, mesh) -> tuple:
    """The spec a leaf of global ``shape`` gets on ``mesh``: the rule,
    except that a quantized leaf adapts where it does not divide. A q4
    weight whose group axis does not divide moves its contraction
    sharding to the packed axis, or, if that does not divide either,
    replicates it with a warning (a silently replicated WEIGHT would
    defeat int4's capacity purpose); a scale demotes silently. A regular
    weight that does not divide raises."""
    spec = rule_spec(key, len(shape))
    if key.endswith("/q4"):
        lead, (a_in, _, a_out) = spec[:-3], spec[-3:]
        G, half = shape[-3], shape[-2]
        if a_in is not None and G % _size(mesh, a_in):
            if half % _size(mesh, a_in) == 0:
                spec = (*lead, None, a_in, a_out)  # packed axis
            else:
                warnings.warn(
                    f"{key}: neither group ({G}) nor packed "
                    f"({half}) axis divides the mesh — weight "
                    "replicated; consider a different group_size")
                spec = (*lead, None, None, a_out)
        return spec
    if key.endswith("/s"):
        return tuple(ax if ax is None or d % _size(mesh, ax) == 0 else None
                     for d, ax in zip(shape, spec))
    for d, ax in zip(shape, spec):
        if d % _size(mesh, ax):
            raise ValueError(
                f"{key}: dim of {d} does not divide over {ax!r} "
                f"({_size(mesh, ax)} ranks) in shape {tuple(shape)}")
    return spec


def param_shardings(params: dict, mesh) -> dict:
    """The effective spec tree of a global parameter tree on ``mesh``
    (``effective_spec``): what ``shard_params`` slices by."""
    return _map_paths(params,
                      lambda key, t: effective_spec(key, t.shape, mesh))


def leaf_spec(key: str, t: torch.Tensor) -> tuple:
    """The spec of a local leaf: the one ``shard_params`` recorded on
    it, else the rule (which every regular leaf keeps)."""
    spec = getattr(t, SPEC_ATTR, None)
    return spec if spec is not None else rule_spec(key, t.dim())


def flat_specs(params: dict) -> dict:
    """``{path: leaf_spec}`` of a local tree, every array of a quantized
    leaf under its own path (``"blocks/wq/q4"``)."""
    out = {}
    _map_paths(params, lambda key, t: out.__setitem__(key,
                                                      leaf_spec(key, t)))
    return out


def local_slices(shape, spec, mesh) -> tuple:
    """This rank's index into a global tensor of ``shape`` under
    ``spec``."""
    idx = []
    for d, ax in zip(shape, spec):
        if ax is None:
            idx.append(slice(None))
            continue
        n, i = axis_size(mesh, ax), axis_index(mesh, ax)
        c = d // n
        idx.append(slice(i * c, (i + 1) * c))
    return tuple(idx)


def shard_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the global ``t`` under ``spec``, as a leaf
    tensor of its own: a copy unless the slice is all of ``t`` (then a
    detached alias of it), so the global tensor can be freed.""" 
    local = t.detach()[local_slices(t.shape, spec, mesh)]
    if local.shape != t.shape:
        local = local.clone()
    return local


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor from every rank's local ``t`` (each rank
    calls), by an all-gather over each sharded dim."""
    from kubeflow_rm_tpu_torch.parallel.collectives import all_gather

    t = t.detach()
    for d, ax in enumerate(spec):
        if ax is not None:
            t = all_gather(t, axis_group(mesh, ax), d)
    return t


def shard_leaf(key: str, t: torch.Tensor, mesh, device=None) -> torch.Tensor:
    """This rank's slice of the global leaf ``t`` at path ``key`` (on
    ``device``, default ``t``'s), recording its effective spec
    (``SPEC_ATTR``). A leaf that already records one is this rank's
    already and is returned as it is."""
    if hasattr(t, SPEC_ATTR):
        return t
    spec = effective_spec(key, t.shape, mesh)
    local = shard_tensor(t, spec, mesh)
    if device is not None:
        local = local.to(device)
    setattr(local, SPEC_ATTR, spec)
    return local


def shard_params(params: dict, mesh, device=None) -> dict:
    """Global tree -> this rank's local tree (``shard_leaf``: leaves
    that are this rank's already pass through), on ``device`` (default
    each leaf's own)."""
    return _map_paths(params,
                      lambda key, t: shard_leaf(key, t, mesh, device))


def global_shape_of(shape, spec, mesh) -> tuple:
    """The global shape of a local ``shape`` under ``spec``."""
    return tuple(d * _size(mesh, ax) for d, ax in zip(shape, spec))


def global_shape(t: torch.Tensor, mesh) -> tuple:
    """The global shape of a local leaf that records its spec."""
    return global_shape_of(t.shape, getattr(t, SPEC_ATTR), mesh)


class Sharder:
    """``init_params``' ``transform`` on a mesh (``models.init_params(...,
    mesh=)``): cuts each draw (a top-level leaf, or one layer of a
    stacked ``blocks`` leaf, plain or quantized) to this rank's slice as
    it is drawn. Every rank draws the same values, and none holds more
    than its shards and one draw whole. On a pp mesh the stacked leaves
    keep only the rank's stage, ``layers`` (``init_tree`` drops the other
    stages' draws as they are made). ``mark`` then records each leaf's
    effective spec on it, as ``shard_params`` does."""

    def __init__(self, mesh, n_layers: int):
        pp = axis_size(mesh, "pp")
        if n_layers % pp:
            raise ValueError(f"n_layers={n_layers} not divisible by "
                             f"pp={pp}")
        per = n_layers // pp
        first = axis_index(mesh, "pp") * per
        self.mesh, self.n_layers, self.specs = mesh, n_layers, {}
        #: the stacked leaves' layers this rank keeps (its pp stage)
        self.layers = range(first, first + per)

    def __call__(self, path: str, t):
        if isinstance(t, dict):
            return {k: self(f"{path}/{k}", v) for k, v in t.items()}
        layer = path.startswith("blocks/")
        spec = effective_spec(
            path, (self.n_layers, *t.shape) if layer else t.shape, self.mesh)
        self.specs[path] = spec
        # one layer's draw: the layer axis (pp) was chosen by ``layers``
        return shard_tensor(t, spec[1:] if layer else spec, self.mesh)

    def mark(self, params: dict) -> dict:
        def one(key, t):
            setattr(t, SPEC_ATTR, self.specs[key])
            return t

        return _map_paths(params, one)


def gather_params(params: dict, mesh) -> dict | None:
    """Local tree -> the global tree in host memory on rank 0 (None on
    the others). Every rank calls; leaves go one at a time."""
    import torch.distributed as dist

    lead = dist.get_rank() == 0

    def one(key, t):
        full = gather_tensor(t, leaf_spec(key, t), mesh)
        return full.cpu() if lead else None

    out = _map_paths(params, one)
    return out if lead else None


def batch_pspec(sequence_sharded: bool = True) -> tuple:
    """Spec for (B, T) token batches: batch over dp+fsdp, seq over sp."""
    return (("dp", "fsdp"), "sp" if sequence_sharded else None)
