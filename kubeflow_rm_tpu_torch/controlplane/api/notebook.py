"""The Notebook fields the port's seams read (copies from
``kubeflow_rm_tpu/controlplane/api/notebook.py``)."""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get

KIND = "Notebook"


def tpu_spec(notebook: dict) -> gpu_api.SliceTopology | None:
    """Resolve ``spec.tpu.acceleratorType`` to a card slice (None for a
    CPU notebook); raises ``UnknownAcceleratorType`` for a type the
    table does not know."""
    t = deep_get(notebook, "spec", "tpu")
    if not t:
        return None
    return gpu_api.lookup(t["acceleratorType"])
