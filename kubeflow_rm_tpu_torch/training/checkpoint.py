"""Train-state checkpoints (counterpart of
``kubeflow_rm_tpu/training/checkpoint.py``).

Each checkpoint is a step directory ``{directory}/{step}/`` holding one
``torch.save`` file: the saved tree as plain dicts of CPU tensors and
Python values, and whether it was a ``TrainState`` or a bare tree. A
save is written into a temporary directory beside it and renamed into
place with ``os.replace``, so a crash mid-save never leaves a partial
step that ``latest_step`` would pick. Saves are synchronous; ``wait``
and ``close`` exist for the JAX package's API.

The call shapes are JAX's: ``save(state, *, force=False)`` takes a
``TrainState`` or any dict with a ``"step"`` entry, and
``restore(cfg=None, mesh=None, step=None)`` gives back the tree as it
was saved, or with a ``cfg`` a ``TrainState`` checked against it.

On a mesh every rank calls both. ``save(state, mesh=mesh)`` gathers the
rank-local state to rank 0 (``train.gather_state``), which writes the
same one-file format; ``restore(cfg, mesh)`` reads the file on every
rank and keeps each rank's slices (``train.state_shardings``), so a
checkpoint written at any mesh, or on one device, restores at any
other, as orbax's does. Trees
with quantized leaves (dicts of int8 and float32 tensors) round trip
unchanged. The format is the port's own: it is NOT orbax-compatible, and
a JAX checkpoint cannot be restored here (nor the other way round).

The optimizer state is any of the trainer's layouts: adam's
``AdamState``, adafactor's ``FactoredState``, or the host-offload
layout ``{leaf key: per-leaf state}`` (``OptimConfig(offload=
"optimizer")``). A host-offload state is saved from host memory and
restored into it (pinned where a CUDA device exists), never onto the
card, whatever ``device`` the parameters go to (JAX's
``abstract_state``), so a resumed run continues bit for bit. On a mesh
each rank's host state is its slices (``train.shard_state``), saved
gathered like the rest.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

from kubeflow_rm_tpu_torch.training.optim import (
    AdamState, FactoredState, host_put,
)
from kubeflow_rm_tpu_torch.training.train import TrainState

_FILE = "state.pt"
_TRAIN_STATE, _TREE = "train_state", "tree"


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _cpu(tree):
    return _map(tree, lambda t: t.detach().cpu())


_OFFLOAD = "offload"
_STATES = {frozenset({"count", "mu", "nu"}): AdamState,
           frozenset({"count", "v_row", "v_col", "v"}): FactoredState}


def _opt_tree(opt) -> dict:
    """An optimizer state as plain dicts of CPU tensors."""
    if isinstance(opt, dict):                      # host-offload layout
        return {_OFFLOAD: {k: _opt_tree(v) for k, v in opt.items()}}
    return {"count": opt.count, **{f: _cpu(getattr(opt, f))
                                   for f in opt.__dataclass_fields__
                                   if f != "count"}}


def _opt_state(tree: dict, device, pin: bool = True):
    """The inverse of ``_opt_tree``: the offload layout in host memory
    (pinned, unless ``pin`` is False: a sharded restore pins only the
    rank's slices), the on-card states on ``device``."""
    if set(tree) == {_OFFLOAD}:
        return {k: _opt_state(_map(v, host_put) if pin else v, None)
                for k, v in tree[_OFFLOAD].items()}
    if device is not None:
        tree = _map(tree, lambda t: t.to(device))
    return _STATES[frozenset(tree)](**tree)


def _as_train_state(tree: dict, device, pin: bool = True) -> TrainState:
    return TrainState(step=int(tree["step"]), params=tree["params"],
                      opt_state=_opt_state(tree["opt_state"], device, pin))


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

    def save(self, state, *, force: bool = False, mesh=None) -> bool:
        """Write ``state`` — a ``TrainState``, or any dict with a
        ``"step"`` entry — at its step. Returns False, writing nothing,
        if that step exists, unless ``force``, which replaces it. With
        ``mesh`` the state is this rank's ``TrainState``: every rank
        calls, rank 0 writes the gathered state."""
        if mesh is not None:
            return self._save_sharded(state, force, mesh)
        if isinstance(state, TrainState):
            kind = _TRAIN_STATE
            tree = {"step": int(state.step), "params": _cpu(state.params),
                    "opt_state": _opt_tree(state.opt_state)}
        elif isinstance(state, dict) and "step" in state:
            kind, tree = _TREE, _cpu(state)
        else:
            raise TypeError("save takes a TrainState or a dict with a "
                            f"'step' entry, got {type(state).__name__}")
        step = int(tree["step"])
        final = self.directory / str(step)
        if final.exists() and not force:
            return False
        tmp = self.directory / f".{step}.tmp-{os.getpid()}"
        old = self.directory / f".{step}.old-{os.getpid()}"
        for d in (tmp, old):
            shutil.rmtree(d, ignore_errors=True)
        tmp.mkdir()
        try:
            torch.save({"kind": kind, "tree": tree}, tmp / _FILE)
            if final.exists():
                os.replace(final, old)
            os.replace(tmp, final)
        finally:
            for d in (tmp, old):
                shutil.rmtree(d, ignore_errors=True)
        for stale in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(stale), ignore_errors=True)
        return True

    def _save_sharded(self, state, force: bool, mesh) -> bool:
        import torch.distributed as dist

        from kubeflow_rm_tpu_torch.training.train import gather_state

        if not isinstance(state, TrainState):
            raise TypeError("a sharded save takes a TrainState, got "
                            f"{type(state).__name__}")
        skip = [(self.directory / str(int(state.step))).exists()
                and not force]
        dist.broadcast_object_list(skip, src=0)
        if skip[0]:
            return False
        full = gather_state(state, mesh)
        if dist.get_rank() == 0:
            self.save(full, force=force)
        dist.barrier()
        return True

    def restore(self, cfg=None, mesh=None, step: int | None = None, *,
                device: str | torch.device | None = None):
        """The latest (or given) step on ``device`` (the card unless the
        caller asks for the CPU), or None when the directory holds no
        checkpoint.

        Without ``cfg`` the tree comes back as it was saved: a
        ``TrainState`` if one was saved, else the dict. With a
        ``TrainConfig`` it is a ``TrainState`` whose parameters are
        checked against ``cfg.model``. With ``mesh`` (and a saved
        ``TrainState``) it is this rank's slices of it.
        """
        from kubeflow_rm_tpu_torch.device import default_device
        from kubeflow_rm_tpu_torch.models.params import check_params

        device = default_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        # loaded on the host; the parameters then go to ``device`` and a
        # host-offload optimizer state stays in host memory. On a mesh
        # the file is mapped, not read: each rank copies out its slices
        saved = torch.load(self.directory / str(step) / _FILE,
                           map_location="cpu", weights_only=True,
                           mmap=mesh is not None)
        if "kind" not in saved:        # written before bare trees were kept
            saved = {"kind": _TRAIN_STATE, "tree": saved}
        tree = saved["tree"]
        if mesh is not None:
            if saved["kind"] != _TRAIN_STATE:
                raise ValueError(f"step {step} holds no train state; a "
                                 "sharded restore needs one")
            if cfg is not None:
                check_params(tree["params"], cfg.model)
            return self._shard(_as_train_state(tree, None, pin=False),
                               mesh, device)
        if saved["kind"] == _TRAIN_STATE:
            tree = dict(tree, params=_map(tree["params"],
                                          lambda t: t.to(device)))
        else:
            tree = _map(tree, lambda t: t.to(device))
        if cfg is None:
            return _as_train_state(tree, device) \
                if saved["kind"] == _TRAIN_STATE else tree
        if not {"step", "params", "opt_state"} <= set(tree):
            raise ValueError(f"step {step} holds no train state (keys "
                             f"{sorted(tree)}); restore it without cfg")
        check_params(tree["params"], cfg.model)
        return _as_train_state(tree, device)

    @staticmethod
    def _shard(state: TrainState, mesh, device) -> TrainState:
        """This rank's slices of a host-memory ``state``, on ``device``."""
        from kubeflow_rm_tpu_torch.parallel.sharding import SPEC_ATTR
        from kubeflow_rm_tpu_torch.training.train import shard_state

        local = shard_state(state, mesh)

        def put(t):
            out = t.to(device)
            if hasattr(t, SPEC_ATTR):
                setattr(out, SPEC_ATTR, getattr(t, SPEC_ATTR))
            return out

        opt = local.opt_state
        if not isinstance(opt, dict):      # the offload layout stays put
            opt = type(opt)(count=opt.count, **{
                f: _map(getattr(opt, f), put)
                for f in opt.__dataclass_fields__ if f != "count"})
        return TrainState(step=local.step, params=_map(local.params, put),
                          opt_state=opt)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        self.wait()
