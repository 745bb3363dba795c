"""Train-state checkpoints (counterpart of
``kubeflow_rm_tpu/training/checkpoint.py``).

Each checkpoint is a step directory ``{directory}/{step}/`` holding one
``torch.save`` file of the ``TrainState`` as plain dicts of CPU tensors
and ints. A save is written into a temporary directory beside it and
renamed into place with ``os.replace``, so a crash mid-save never
leaves a partial step that ``latest_step`` would pick. Saves are
synchronous; ``wait`` and ``close`` exist for the JAX package's API.

The format is the port's own: it is NOT orbax-compatible, and a JAX
checkpoint cannot be restored here (nor the other way round).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

from kubeflow_rm_tpu_torch.training.optim import AdamState
from kubeflow_rm_tpu_torch.training.train import TrainState

_FILE = "state.pt"


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class Checkpointer:
    """Step-directory checkpoints with retention of the newest
    ``max_to_keep``."""

    def __init__(self, directory, *, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.max_to_keep = max_to_keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit()
                      and (p / _FILE).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> bool:
        """Write ``state`` at its step; False if that step exists."""
        step = int(state.step)
        final = self.directory / str(step)
        if final.exists():
            return False
        tree = {"step": step,
                "params": _map(state.params, lambda t: t.detach().cpu()),
                "opt_state": {
                    "count": state.opt_state.count,
                    "mu": _map(state.opt_state.mu, lambda t: t.cpu()),
                    "nu": _map(state.opt_state.nu, lambda t: t.cpu())}}
        tmp = self.directory / f".{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        try:
            torch.save(tree, tmp / _FILE)
            os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return True

    def restore(self, step: int | None = None,
                device: str | torch.device | None = None
                ) -> TrainState | None:
        """The latest (or given) step's state on ``device`` (the card
        unless the caller asks for the CPU), or None when the directory
        holds no checkpoint."""
        from kubeflow_rm_tpu_torch.device import default_device

        device = default_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        tree = torch.load(self.directory / str(step) / _FILE,
                          map_location=device, weights_only=True)
        opt = tree["opt_state"]
        return TrainState(step=tree["step"], params=tree["params"],
                          opt_state=AdamState(count=opt["count"],
                                              mu=opt["mu"], nu=opt["nu"]))

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        self.wait()
