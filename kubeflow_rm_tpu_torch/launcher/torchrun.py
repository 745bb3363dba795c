"""The torchrun env of each card from the platform's rendezvous contract
(counterpart of ``kubeflow_rm_tpu/launcher/torchxla.py``).

The webhook injects the same env into every pod whatever the framework:
``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES`` (+ ``MEGASCALE_*`` on a
multislice job). JAX and torch_xla run one process per host; the port
runs one process per card, so a host of ``cards_per_host`` cards starts
that many ranks, each with its own ``LOCAL_RANK``, and
:func:`torchrun_env` gives each the ``torch.distributed`` env torchrun
would: ``RANK = process_id × cards_per_host + local_rank``,
``WORLD_SIZE = num_hosts × cards_per_host``, ``LOCAL_RANK``,
``MASTER_ADDR`` (slice 0's worker 0, or the multislice coordinator) and
``MASTER_PORT``. ``parallel.distributed.initialize`` reads exactly those
(torchrun's spelling wins over the webhook's there), on NCCL for the
card.
"""

from __future__ import annotations

import os

from kubeflow_rm_tpu_torch.parallel.distributed import TpuEnv, tpu_env

#: the conventional torch.distributed master port (init_method env://)
DEFAULT_MASTER_PORT = 12355


def torchrun_env(environ=None, *, cards_per_host: int | None = None,
                 local_rank: int | None = None,
                 master_port: int = DEFAULT_MASTER_PORT) -> dict[str, str]:
    """The torchrun env of one card's process.

    ``cards_per_host`` (None: the visible card count) is the ranks each
    host runs; ``local_rank`` (None: ``LOCAL_RANK`` of ``environ``, else
    0) is this process's card on its host. Ranks are numbered
    slice-major then card by card, so a host's ranks are contiguous and
    rank 0 is slice 0's worker 0's first card.

    Raises ``ValueError`` on a contract violation (an ordinal outside
    the slice, a local rank outside the host's cards): the platform
    injecting inconsistent env is a bug worth failing loudly on.
    """
    e = os.environ if environ is None else environ
    env: TpuEnv = tpu_env(e)
    if env.worker_hostnames and env.worker_id >= env.hosts_per_slice:
        raise ValueError(
            f"TPU_WORKER_ID={env.worker_id} outside the "
            f"{env.hosts_per_slice}-host slice "
            f"(TPU_WORKER_HOSTNAMES={','.join(env.worker_hostnames)})")
    if cards_per_host is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card visible: pass cards_per_host")
        cards = torch.cuda.device_count()
    else:
        cards = cards_per_host
    if cards < 1:
        raise ValueError(f"cards_per_host={cards}: a host runs a rank a "
                         f"card, at least one")
    local = int(e.get("LOCAL_RANK", "0")) if local_rank is None \
        else local_rank
    if not 0 <= local < cards:
        raise ValueError(f"LOCAL_RANK={local} outside the host's "
                         f"{cards} cards")
    master = env.worker_hostnames[0] if env.worker_hostnames else "localhost"
    if env.is_multislice and env.coordinator:
        master = env.coordinator.split(":")[0]
    return {
        "MASTER_ADDR": master,
        "MASTER_PORT": str(master_port),
        "RANK": str(env.process_id * cards + local),
        "LOCAL_RANK": str(local),
        "WORLD_SIZE": str(env.num_hosts * cards),
    }


def apply_env(environ=None, **kw) -> dict[str, str]:
    """Merge ``torchrun_env`` into ``os.environ`` (explicit user
    overrides win). Returns the mapping that was applied."""
    mapping = torchrun_env(environ, **kw)
    for k, v in mapping.items():
        os.environ.setdefault(k, v)
    return mapping


def init_distributed(environ=None, *, device=None, **kw):
    """Join ``torch.distributed`` from the platform contract: the
    torchrun env of this card (:func:`apply_env`, so an override already
    in ``os.environ`` wins) through ``parallel.distributed.initialize``,
    NCCL on the card (``device`` None), gloo where the caller asks for
    the CPU. A process already in a group returns None and joins
    nothing; otherwise ``torch.distributed``."""
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.parallel.distributed import initialize

    if dist.is_initialized():
        return None
    mapping = apply_env(environ, **kw)
    initialize({k: os.environ[k] for k in mapping}, device=device)
    return dist
