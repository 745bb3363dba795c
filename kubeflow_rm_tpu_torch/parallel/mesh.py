"""Device-mesh construction (counterpart of
``kubeflow_rm_tpu/parallel/mesh.py``).

Axis convention, outermost to innermost, as in the JAX package:

- ``dp``   pure data parallelism (params replicated);
- ``pp``   pipeline stages (the GPipe schedule of ``pipeline``);
- ``fsdp`` data parallelism with parameter sharding (ZeRO-3 style);
- ``ep``   expert parallelism (MoE expert dim sharded);
- ``sp``   sequence parallelism (ring / zigzag / Ulysses attention);
- ``tp``   tensor (Megatron-style) parallelism — innermost, so its
           per-block all-reduces take the closest ranks.

One process drives one card (torchrun's model), so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, with those six names in that order. Rank r sits
at the row-major coordinate of r in the mesh shape: ``tp`` varies
fastest, exactly as ``jax.make_mesh`` lays devices out.

``axis_group``, ``axis_size`` and ``axis_index`` read the mesh for one
axis or for several flattened together (the first named axis major),
which is how the port spells JAX's multi-axis names such as
``("dp", "fsdp")``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    fsdp: int = -1  # -1: absorb all remaining devices
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        sizes = [self.dp, self.pp, self.fsdp, self.ep, self.sp, self.tp]
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        n_wild = sizes.count(-1)
        if n_wild > 1:
            raise ValueError("at most one mesh axis may be -1")
        if n_wild == 1:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {known}"
                )
            sizes[sizes.index(-1)] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXES, sizes))} does not cover {n_devices} devices"
            )
        return tuple(sizes)


def _device_type(device) -> str:
    from kubeflow_rm_tpu_torch.device import default_device

    return default_device(device).type


def make_mesh(config: MeshConfig | None = None,
              device: str | torch.device | None = None) -> DeviceMesh:
    """The six-axis mesh over every rank of the default process group
    (``distributed.initialize`` first). ``device`` (None: the card) is
    the mesh's device type. Raises if the sizes do not multiply to the
    world size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.distributed."
            "initialize() (under torchrun, or with the webhook env) first")
    config = config or MeshConfig()
    shape = config.resolve(dist.get_world_size())
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=AXES)


def make_hybrid_mesh(config: MeshConfig | None = None, *, n_slices: int,
                     device: str | torch.device | None = None) -> DeviceMesh:
    """Multislice mesh: ``dp`` spans the slices, fsdp/sp/tp stay inside
    each. ``config.dp`` must equal ``n_slices`` (or be -1). Ranks are
    slice-major (``distributed.initialize``), so each slice's ranks form
    one contiguous block of the mesh."""
    config = config or MeshConfig()
    if config.dp == -1:
        config = MeshConfig(dp=n_slices, pp=config.pp, fsdp=config.fsdp,
                            ep=config.ep, sp=config.sp, tp=config.tp)
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs a process group")
    shape = config.resolve(dist.get_world_size())
    if shape[0] != n_slices:
        raise ValueError(
            f"dp axis ({shape[0]}) must equal n_slices ({n_slices}) — "
            "dp is the DCN axis in a multislice job")
    return make_mesh(config, device)


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{axis: size}`` (JAX's ``mesh.shape``)."""
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along ``axes`` (one name or several)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes(axes))


def axis_index(mesh: DeviceMesh, axes) -> int:
    """This rank's index along ``axes`` flattened, the first axis major
    (JAX's ``axis_index`` of a multi-axis name)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in _axes(axes):
        d = names.index(a)
        idx = idx * int(mesh.mesh.shape[d]) + coord[d]
    return idx


def axis_group(mesh: DeviceMesh, axes) -> dist.ProcessGroup:
    """The process group of the ranks that share this rank's coordinates
    on every axis but ``axes``, in ``axis_index`` order. One axis is the
    mesh's own group; several are made once per mesh, by every rank in
    the same order (the callers' code paths are the same on each)."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_kfrm_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        grid = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axis_size(mesh, axes))
        group, _ = dist.new_subgroups_by_enumeration(grid.tolist())
        cache[axes] = group
    return cache[axes]


def comm_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's collectives on ``mesh`` take tensors on:
    its card under NCCL, the CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
