"""The in-image process layer for multi-card and multi-host slices
(counterpart of ``kubeflow_rm_tpu/launcher``).

The port runs one process per card. ``torchrun.py`` maps the webhook's
rendezvous env to the torchrun env of each card; ``agent.py`` is the
worker agent that joins the slice's process group through
``parallel.distributed.initialize`` and serves ``/healthz``."""

from kubeflow_rm_tpu_torch.launcher.agent import WorkerAgent

__all__ = ["WorkerAgent"]
