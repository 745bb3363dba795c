"""Multi-host bootstrap from the platform-injected env (counterpart of
``kubeflow_rm_tpu/parallel/distributed.py``).

The notebook webhook injects into every pod of a notebook:

- ``TPU_WORKER_ID`` / ``TPU_WORKER_HOSTNAMES`` — the pod's ordinal
  within its slice and the headless-service DNS of its slice peers;
- ``MEGASCALE_NUM_SLICES`` / ``MEGASCALE_SLICE_ID`` /
  ``MEGASCALE_COORDINATOR_ADDRESS`` — present only on multislice
  notebooks, carrying the data-center dimension.

``initialize`` turns that env into one ``torch.distributed`` process
group: rank = slice_id·hosts_per_slice + worker_id, rendezvous at slice
0's worker 0 (or the multislice coordinator), as JAX's
``jax.distributed.initialize`` call does. Where torchrun's
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR`` are set they win:
they are torch's spelling of the same rendezvous, one process per card.
The backend is NCCL for a CUDA device and gloo for the CPU.
"""

from __future__ import annotations

import atexit
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

DEFAULT_COORDINATOR_PORT = 8476


@dataclass(frozen=True)
class TpuEnv:
    worker_id: int               # ordinal within the slice
    worker_hostnames: list[str]  # this slice's peers
    accelerator_type: str | None
    topology: str | None
    num_slices: int = 1
    slice_id: int = 0
    coordinator: str | None = None  # multislice: slice 0's worker 0

    @property
    def hosts_per_slice(self) -> int:
        return max(1, len(self.worker_hostnames))

    @property
    def num_hosts(self) -> int:
        """Global process count across every slice."""
        return self.hosts_per_slice * max(1, self.num_slices)

    @property
    def process_id(self) -> int:
        """Global rank (slice-major, matching pod ordinals)."""
        return self.slice_id * self.hosts_per_slice + self.worker_id

    @property
    def is_multihost(self) -> bool:
        return self.num_hosts > 1

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1


def tpu_env(environ=None) -> TpuEnv:
    """Read the rendezvous env injected by the notebook webhook."""
    env = os.environ if environ is None else environ
    hostnames = [
        h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
    ]
    return TpuEnv(
        worker_id=int(env.get("TPU_WORKER_ID", "0")),
        worker_hostnames=hostnames,
        accelerator_type=env.get("TPU_ACCELERATOR_TYPE"),
        topology=env.get("TPU_TOPOLOGY"),
        num_slices=int(env.get("MEGASCALE_NUM_SLICES", "1")),
        slice_id=int(env.get("MEGASCALE_SLICE_ID", "0")),
        coordinator=env.get("MEGASCALE_COORDINATOR_ADDRESS"),
    )


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(environ=None, port: int = DEFAULT_COORDINATOR_PORT,
               device: str | torch.device | None = None) -> TpuEnv:
    """Join (or skip) the job's process group; returns the webhook env.

    - torchrun's env (``WORLD_SIZE`` set): ``init_process_group`` at
      ``MASTER_ADDR:MASTER_PORT`` with its rank and world size, and on
      a CUDA device ``torch.cuda.set_device(LOCAL_RANK)`` first.
    - otherwise the webhook's: a no-op on single-host single-slice, else
      a group of ``num_hosts`` ranks at ``coordinator:port``, the
      coordinator being slice 0's worker 0 (or
      ``MEGASCALE_COORDINATOR_ADDRESS``), rank ``process_id``.

    ``device`` (None: the card) picks the backend. A process that has
    already joined a group returns at once. A group joined here is left
    at interpreter exit (``shutdown``, registered with ``atexit``): a
    gloo group still alive when the interpreter tears down its threads
    can abort the process (``terminate called without an active
    exception``) after its work is done.
    """
    from kubeflow_rm_tpu_torch.device import default_device

    env_map = os.environ if environ is None else environ
    env = tpu_env(env_map)
    if dist.is_initialized():
        return env
    dev = default_device(device)
    backend = backend_for(dev)
    if "WORLD_SIZE" in env_map:
        world = int(env_map["WORLD_SIZE"])
        rank = int(env_map.get("RANK", "0"))
        if dev.type == "cuda":
            torch.cuda.set_device(int(env_map.get("LOCAL_RANK", "0")))
        addr = env_map.get("MASTER_ADDR", "localhost")
        master_port = env_map.get("MASTER_PORT", str(port))
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{addr}:{master_port}",
                                world_size=world, rank=rank)
        atexit.register(shutdown)
        return env
    if not env.is_multihost:
        return env
    if env.is_multislice and env.coordinator:
        coordinator = env.coordinator
    else:
        coordinator = env.worker_hostnames[0]
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}:{port}",
                            world_size=env.num_hosts, rank=env.process_id)
    atexit.register(shutdown)
    return env


def shutdown() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0
