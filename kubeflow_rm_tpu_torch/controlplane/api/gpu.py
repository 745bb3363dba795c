"""Card slice topology: the GPU counterpart of
``kubeflow_rm_tpu/controlplane/api/tpu.py`` — the platform's accelerator
vocabulary, which the notebook controller, the injection webhook, the
scheduler and the admission pricer all render from.

A slice is one or more hosts of NVIDIA H100 80GB cards (one pod per
host). The webhook host has no card, so the table carries what the
pricer and the scheduler need: the card count, the hosts, each card's
memory and its bf16 peak. The memory is the card's own
``torch.cuda.get_device_properties(0).total_memory`` as measured on an
H100 80GB HBM3 (85,017,493,504 bytes = 79.1787109375 GiB); the peak is
NVIDIA's dense bf16 figure for the SXM part.

The node vocabulary is GKE's for GPU node pools: the card count is the
``nvidia.com/gpu`` resource, the accelerator the
``cloud.google.com/gke-accelerator`` label, and the cards on a host GPU
feature discovery's ``nvidia.com/gpu.count`` label (the counterpart of
the TPU topology label). A single-host slice selects on the accelerator
alone, a multi-host one on both.
"""

from __future__ import annotations

from dataclasses import dataclass

NVIDIA_GPU_RESOURCE = "nvidia.com/gpu"
#: synthetic allocatable key carrying a node's aggregate card memory
#: (GiB as a decimal string) — the scheduler's second packing axis,
#: surfaced by the fake kubelet as a first-class quantity
NVIDIA_GPU_MEMORY_RESOURCE = "nvidia.com/gpu-memory-gib"
NODE_LABEL_ACCELERATOR = "cloud.google.com/gke-accelerator"
NODE_LABEL_TOPOLOGY = "nvidia.com/gpu.count"

# ---- predictive admission vocabulary (tpu.kubeflow.org/) -------------
#: JSON declaration of the training workload a Notebook/TPUJob intends
#: to run, priced at admission
DECLARED_WORKLOAD_ANNOTATION = "tpu.kubeflow.org/declared-workload"
#: stamped by the admission pricer: predicted peak memory of the whole
#: slice (decimal GB, float as str) and predicted FLOPs per step
PREDICTED_HBM_ANNOTATION = "tpu.kubeflow.org/predicted-hbm-gb"
PREDICTED_FLOPS_ANNOTATION = "tpu.kubeflow.org/predicted-flops"

#: an H100 80GB HBM3's ``total_memory`` in GiB (measured on the card)
H100_80GB_GIB = 79.1787109375
#: NVIDIA's dense bf16 peak of one H100 SXM, FLOP/s
H100_BF16_FLOPS = 989e12


@dataclass(frozen=True)
class SliceTopology:
    accelerator_type: str   # user-facing, e.g. "h100-80gb-4"
    gke_accelerator: str    # node label value
    topology: str           # the cards on a host, e.g. "4"
    cards: int              # total cards in the slice
    hosts: int              # pods per slice (one per host)
    card_flops_bf16: float  # peak dense bf16 FLOP/s per card
    hbm_gib_per_chip: float = H100_80GB_GIB   # memory per card (GiB)

    @property
    def cards_per_host(self) -> int:
        return self.cards // self.hosts

    @property
    def multihost(self) -> bool:
        return self.hosts > 1

    @property
    def hbm_gib_per_host(self) -> float:
        return self.cards_per_host * self.hbm_gib_per_chip


_H100 = "nvidia-h100-80gb"

_TOPOLOGIES = [
    SliceTopology("h100-80gb-1", _H100, "1", 1, 1, H100_BF16_FLOPS),
    SliceTopology("h100-80gb-4", _H100, "4", 4, 1, H100_BF16_FLOPS),
    SliceTopology("h100-80gb-8", _H100, "8", 8, 1, H100_BF16_FLOPS),
    # multi-host: hosts of 4 or 8 cards, one pod per host
    SliceTopology("h100-80gb-2x4", _H100, "4", 8, 2, H100_BF16_FLOPS),
    SliceTopology("h100-80gb-2x8", _H100, "8", 16, 2, H100_BF16_FLOPS),
]

TOPOLOGIES: dict[str, SliceTopology] = {
    t.accelerator_type: t for t in _TOPOLOGIES
}


class UnknownAcceleratorType(ValueError):
    pass


def lookup(accelerator_type: str) -> SliceTopology:
    try:
        return TOPOLOGIES[accelerator_type]
    except KeyError:
        raise UnknownAcceleratorType(
            f"unknown GPU acceleratorType {accelerator_type!r}; known: "
            f"{sorted(TOPOLOGIES)}"
        ) from None


def by_node_labels(gke_accelerator: str, topology: str) -> SliceTopology | None:
    """Reverse lookup from node labels (spawner capacity discovery). A
    GPU node's labels name one host's shape, so this is the single-host
    type of that card count (the multi-host types share it)."""
    for t in _TOPOLOGIES:
        if t.gke_accelerator == gke_accelerator and t.topology == topology:
            return t
    return None


def slice_types_on(nodes) -> list[str]:
    """The slice types ``nodes`` can host, sorted: every type whose host
    shape (accelerator, cards a host) some node's labels name. A GPU
    node's labels name its host's shape, not a slice, so two 4-card
    hosts give ``h100-80gb-4`` and ``h100-80gb-2x4``."""
    shapes = set()
    for node in nodes:
        labels = node["metadata"].get("labels") or {}
        shapes.add((labels.get(NODE_LABEL_ACCELERATOR),
                    labels.get(NODE_LABEL_TOPOLOGY)))
    return sorted(t.accelerator_type for t in _TOPOLOGIES
                  if (t.gke_accelerator, t.topology) in shapes)
