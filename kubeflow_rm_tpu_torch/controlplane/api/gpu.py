"""Card slice topology: the GPU counterpart of
``kubeflow_rm_tpu/controlplane/api/tpu.py``'s ``SliceTopology`` and
``lookup``, and the predictive-admission annotation keys.

A slice here is one host of NVIDIA H100 80GB cards. The webhook host has
no card, so the table carries what the pricer needs: the card count, the
cards on a host, each card's memory and its bf16 peak. The memory is the
card's own ``torch.cuda.get_device_properties(0).total_memory`` as
measured on an H100 80GB HBM3 (85,017,493,504 bytes = 79.1787109375
GiB); the peak is NVIDIA's dense bf16 figure for the SXM part.
"""

from __future__ import annotations

from dataclasses import dataclass

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


_H100 = "nvidia-h100-80gb"

_TOPOLOGIES = [
    SliceTopology("h100-80gb-1", _H100, "1", 1, 1, H100_BF16_FLOPS),
    SliceTopology("h100-80gb-4", _H100, "4", 4, 1, H100_BF16_FLOPS),
    SliceTopology("h100-80gb-8", _H100, "8", 8, 1, H100_BF16_FLOPS),
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
