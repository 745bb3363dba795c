"""Worker agent for the ranks of a slice that run no primary program
(counterpart of ``kubeflow_rm_tpu/launcher/agent.py``).

On a multi-host slice the platform starts the same image on every host.
JupyterLab (or a TPUJob's learner program) runs exactly once, on global
rank 0; every other rank must still join the job's process group for a
program to span the slice. The port runs one process per card, so this
agent is that process for each card other than rank 0's:

1. read the webhook-injected rendezvous env (``TPU_WORKER_ID`` /
   ``TPU_WORKER_HOSTNAMES``, ``parallel/distributed.py``) and this
   card's ``LOCAL_RANK``,
2. join ``torch.distributed`` with the torchrun env of its card
   (``launcher/torchrun.py``: rank ``process_id × cards_per_host +
   local_rank``, rendezvous at slice 0's worker 0), NCCL on the card,
3. serve ``/healthz`` (the kubelet readiness probe for peer pods),
4. block until the process is terminated (slice teardown).
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import logging
import os
import threading
import time

from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
from kubeflow_rm_tpu_torch.launcher.torchrun import (
    DEFAULT_MASTER_PORT, torchrun_env,
)
from kubeflow_rm_tpu_torch.parallel.distributed import initialize, tpu_env

log = logging.getLogger("kubeflow_rm_tpu_torch.launcher")

HEALTH_PORT = 8080


@dataclasses.dataclass(frozen=True)
class RoleEnv:
    """The TPUJob half of the rendezvous contract (webhook → agent).

    Parsed from the ``TPU_JOB_*`` vars the webhook stamps on every gang
    member, accelerator pods and CPU actors alike. The accelerator-scoped
    vars (``TPU_WORKER_*``) are a separate, slice-local contract: an
    actor pod has the role env but not the accelerator env, which is how
    the agent tells the two apart.
    """
    job: str
    role: str
    role_index: int
    role_hostnames: tuple[str, ...]
    #: every role's hostname list, keyed by the role name as it appears
    #: in the job spec (lowercased back from the env-var suffix)
    peers: dict[str, tuple[str, ...]]
    learner_address: str

    @property
    def in_gang(self) -> bool:
        return bool(self.job)


def role_env(environ=None) -> RoleEnv:
    """Parse the ``TPU_JOB_*`` rendezvous env; never raises — absent
    vars yield an empty ``RoleEnv`` (``in_gang`` False)."""
    e = os.environ if environ is None else environ
    try:
        idx = int(e.get(tj_api.ENV_JOB_ROLE_INDEX, "0"))
    except ValueError:
        idx = 0
    peers: dict[str, tuple[str, ...]] = {}
    for key, val in e.items():
        if not key.startswith(tj_api.ENV_JOB_HOSTNAMES_PREFIX):
            continue
        rname = key[len(tj_api.ENV_JOB_HOSTNAMES_PREFIX):]
        peers[rname.lower().replace("_", "-")] = tuple(
            h for h in val.split(",") if h)
    own = tuple(h for h in e.get(
        tj_api.ENV_JOB_ROLE_HOSTNAMES, "").split(",") if h)
    return RoleEnv(
        job=e.get(tj_api.ENV_JOB_NAME, ""),
        role=e.get(tj_api.ENV_JOB_ROLE, ""),
        role_index=idx,
        role_hostnames=own,
        peers=peers,
        learner_address=e.get(tj_api.ENV_LEARNER_ADDRESS, ""),
    )


class WorkerAgent:
    """One card's agent. ``local_rank`` (None: ``LOCAL_RANK`` of the env,
    else 0) is its card on the host; ``cards_per_host`` (None: the
    visible card count) the ranks a host runs; ``device`` (None: the
    card) picks NCCL or, for ``"cpu"``, gloo. ``health_port`` (None:
    ``HEALTH_PORT + local_rank``, so a host's agents never share one; 0:
    an ephemeral port)."""

    def __init__(self, environ=None, *, health_port: int | None = None,
                 local_rank: int | None = None,
                 cards_per_host: int | None = None, device=None,
                 master_port: int = DEFAULT_MASTER_PORT):
        e = os.environ if environ is None else environ
        self.env = tpu_env(e)
        self.role = role_env(e)
        self.local_rank = (int(e.get("LOCAL_RANK", "0"))
                           if local_rank is None else local_rank)
        self.cards_per_host = cards_per_host
        self.device = device
        self.master_port = master_port
        self.health_port = (HEALTH_PORT + self.local_rank
                            if health_port is None else health_port)
        self._httpd = None
        self._ready = False

    @property
    def is_actor(self) -> bool:
        """A CPU-only gang member: role rendezvous env but no accelerator
        env. Actors never join the process group — the learner slice is
        its own world; actors talk to it over the learner address
        (``TPU_JOB_LEARNER_ADDRESS``) at the application layer."""
        return self.role.in_gang and not self.env.accelerator_type

    @property
    def is_worker_zero(self) -> bool:
        """True only for the GLOBAL rank 0 (slice 0, worker 0, card 0):
        JupyterLab runs exactly once in the whole job."""
        return self.env.process_id == 0 and self.local_rank == 0

    def start_health_server(self) -> int:
        """Serve /healthz; returns the bound port (ephemeral if 0)."""
        agent = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                body = json.dumps({
                    "ready": agent._ready,
                    "worker_id": agent.env.worker_id,
                    "local_rank": agent.local_rank,
                    "hosts": agent.env.num_hosts,
                    **({"job": agent.role.job,
                        "role": agent.role.role,
                        "role_index": agent.role.role_index}
                       if agent.role.in_gang else {}),
                }).encode()
                self.send_response(200 if agent._ready else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("0.0.0.0", self.health_port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def join_slice(self, *, retry_interval_s: float = 15.0,
                   max_attempts: int | None = None) -> None:
        """Join the slice's process group with this card's torchrun env.

        A malformed rendezvous env raises at once. Otherwise the join is
        retried until the rendezvous answers: rank 0 only starts it when
        the user's notebook kernel initializes, which can be minutes to
        hours after peer pods boot. ``max_attempts`` bounds the loop for
        tests.
        """
        env_map = dict_env(self.env)
        env_map.update(torchrun_env(env_map,
                                    cards_per_host=self.cards_per_host,
                                    local_rank=self.local_rank,
                                    master_port=self.master_port))
        attempt = 0
        while True:
            attempt += 1
            try:
                initialize(env_map, device=self.device)
                break
            except (ValueError, TypeError):
                raise
            except Exception as e:
                if max_attempts is not None and attempt >= max_attempts:
                    raise
                # transient (rendezvous not up, DNS settling): retry,
                # escalating to WARNING once it stops looking like a
                # normal kernel-start delay so a wedged slice is loud
                level = logging.INFO if attempt <= 8 else logging.WARNING
                log.log(level,
                        "rank %s (slice %d worker %d card %d): rendezvous "
                        "%s:%s not up yet (attempt %d: %s); retrying in "
                        "%.0fs", env_map["RANK"], self.env.slice_id,
                        self.env.worker_id, self.local_rank,
                        env_map["MASTER_ADDR"], env_map["MASTER_PORT"],
                        attempt, e, retry_interval_s)
                time.sleep(retry_interval_s)
        self._ready = True
        log.info("rank %s of %s joined the slice", env_map["RANK"],
                 env_map["WORLD_SIZE"])

    def run_forever(self) -> None:
        import signal
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *a: stop.set())
        stop.wait()
        if self._httpd:
            self._httpd.shutdown()


def dict_env(env) -> dict:
    """Round-trip a ``TpuEnv`` back to the webhook's env contract,
    ``MEGASCALE_*`` included (without them the world would be
    slice-local and the global job could never assemble)."""
    return {
        "TPU_WORKER_ID": str(env.worker_id),
        "TPU_WORKER_HOSTNAMES": ",".join(env.worker_hostnames),
        **({"TPU_ACCELERATOR_TYPE": env.accelerator_type}
           if env.accelerator_type else {}),
        **({"TPU_TOPOLOGY": env.topology} if env.topology else {}),
        **({"MEGASCALE_NUM_SLICES": str(env.num_slices),
            "MEGASCALE_SLICE_ID": str(env.slice_id)}
           if env.num_slices > 1 else {}),
        **({"MEGASCALE_COORDINATOR_ADDRESS": env.coordinator}
           if env.coordinator else {}),
    }


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    agent = WorkerAgent()
    if agent.is_actor:
        # CPU actor in a TPUJob gang: nothing to rendezvous at the
        # process-group layer — serve readiness and idle; the actor
        # program does its work against TPU_JOB_LEARNER_ADDRESS
        log.info("actor %s[%d] of job %s: learner at %s",
                 agent.role.role, agent.role.role_index,
                 agent.role.job, agent.role.learner_address or "<none>")
        agent.start_health_server()
        agent._ready = True
        agent.run_forever()
        return
    if agent.is_worker_zero:
        # rank 0 runs JupyterLab (notebooks) or the learner program as a
        # separate service; the agent has nothing to do
        log.info("rank 0: the primary program owns this card; agent "
                 "exiting")
        return
    agent.start_health_server()
    agent.join_slice()
    agent.run_forever()


if __name__ == "__main__":
    main()
