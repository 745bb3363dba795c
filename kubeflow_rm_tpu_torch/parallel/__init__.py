"""Parallel layers of the port (counterpart of
``kubeflow_rm_tpu/parallel``): the process-group bootstrap
(``distributed``), the six-axis mesh (``mesh``), the sharding rules
(``sharding``), the autograd collectives (``collectives``), the model's
view of a mesh (``sharded``), the sequence-parallel attention schedules
(``ring_attention``, ``zigzag_ring``, ``ulysses``), the GPipe schedule
over ``pp`` (``pipeline``) and the dense-dispatch MoE layer (``moe``)."""

from kubeflow_rm_tpu_torch.parallel.mesh import (
    MeshConfig, make_hybrid_mesh, make_mesh,
)
from kubeflow_rm_tpu_torch.parallel.pipeline import (
    pipeline_forward, pipeline_forward_with_aux,
)
from kubeflow_rm_tpu_torch.parallel.ring_attention import (
    ring_attention, ring_self_attention,
)
from kubeflow_rm_tpu_torch.parallel.sharding import (
    batch_pspec, param_pspecs, param_shardings,
)
from kubeflow_rm_tpu_torch.parallel.ulysses import (
    ulysses_attention, ulysses_self_attention,
)
from kubeflow_rm_tpu_torch.parallel.zigzag_ring import (
    zigzag_permutation, zigzag_positions, zigzag_ring_attention,
    zigzag_ring_self_attention,
)

__all__ = [
    "MeshConfig",
    "batch_pspec",
    "make_hybrid_mesh",
    "make_mesh",
    "param_pspecs",
    "param_shardings",
    "pipeline_forward",
    "pipeline_forward_with_aux",
    "ring_attention",
    "ring_self_attention",
    "ulysses_attention",
    "ulysses_self_attention",
    "zigzag_permutation",
    "zigzag_positions",
    "zigzag_ring_attention",
    "zigzag_ring_self_attention",
]
