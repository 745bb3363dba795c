"""Shard supervisor: N worker processes + respawn-in-place (the port's
copy of ``kubeflow_rm_tpu/controlplane/shard/runner.py``).

``ShardRunner`` owns the deployment topology: it picks one fixed port
and one WAL directory per shard BEFORE anything starts (the ring and
every client derive from this map, and a respawned shard must rebind
the same port and replay the same WAL), spawns each worker via
``multiprocessing`` spawn (no forked locks/sockets from the parent),
health-waits on ``/healthz``, and supervises — a shard that dies
without being asked (or is SIGKILLed by the chaos test) is respawned
in place, where its boot path replays snapshot + WAL and rejoins the
ring at the same position.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import signal
import socket
import threading
import time
import urllib.request

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane.shard.worker import (
    shard_worker_main,
)

log = logging.getLogger("kubeflow_rm_tpu_torch.shard.runner")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ShardRunner:
    def __init__(self, n_shards: int, *, base_dir: str | None = None,
                 wal: bool = True, manager_workers: int = 8,
                 auto_ready: bool = True, hang_dump_s: float = 0.0,
                 supervise: bool = True, tracing: bool = False,
                 on_death=None):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self._ctx = multiprocessing.get_context("spawn")
        self._procs: dict[str, multiprocessing.process.BaseProcess] = {}
        self._cfgs: dict[str, dict] = {}
        # retired (merged-away) shards keep their cfg so the handoff
        # coordinator can still resolve ``wal_dir(name)`` post-merge
        self._retired: dict[str, dict] = {}
        # the intentional-shutdown handshake: names whose next exit is
        # a deliberate scale-down, NOT a death — the watchdog must not
        # count it, alert on it, or respawn it
        self._expected: set[str] = set()
        self._next_index = n_shards
        self._stopping = False
        self._watchdog_thread: threading.Thread | None = None
        self._lock = make_lock("shard.watchdog")
        self._supervise = supervise
        self._base_dir = base_dir
        self._wal = wal
        self._template = {
            "manager_workers": manager_workers,
            "auto_ready": auto_ready, "hang_dump_s": hang_dump_s,
            "tracing": tracing,
        }
        # flight-recorder hook: ``on_death(name, exitcode)`` fires from
        # the watchdog thread AFTER the respawn is issued, so the
        # callback (which may scrape /metrics, dump bundles, ...) never
        # delays recovery
        self._on_death = on_death
        for i in range(n_shards):
            self._make_cfg(f"shard-{i}")

    def _make_cfg(self, name: str) -> dict:
        wal_dir = None
        if self._wal:
            wal_dir = os.path.join(self._base_dir or ".", "wal", name)
            os.makedirs(wal_dir, exist_ok=True)
        cfg = {
            "name": name, "port": _free_port(), "wal_dir": wal_dir,
            # span collection in the worker: a respawned shard
            # re-reads this, so the tracing arm survives chaos kills
            **self._template,
        }
        self._cfgs[name] = cfg
        return cfg

    # ---- topology ----------------------------------------------------
    @property
    def names(self) -> list[str]:
        return list(self._cfgs)

    @property
    def urls(self) -> dict[str, str]:
        return {n: f"http://127.0.0.1:{c['port']}"
                for n, c in self._cfgs.items()}

    def wal_dir(self, name: str) -> str | None:
        cfg = self._cfgs.get(name) or self._retired[name]
        return cfg["wal_dir"]

    def pids(self) -> dict[str, int]:
        """Each live shard's worker pid (the smoke's CUDA-context gate
        and the process tests read these)."""
        return {name: p.pid for name, p in self._procs.items()
                if p.pid is not None}

    def liveness(self) -> dict[str, bool]:
        """Per-shard aliveness as the supervisor sees it — the flight
        recorder's ``shard_liveness`` section."""
        return {name: p.is_alive() for name, p in self._procs.items()}

    def set_on_death(self, fn) -> None:
        """Late-bind the watchdog death hook (the chaos harness builds
        its observer after the runner, which already owns the ports)."""
        self._on_death = fn

    # ---- lifecycle ---------------------------------------------------
    def start(self, timeout: float = 60.0) -> None:
        from kubeflow_rm_tpu_torch.controlplane import metrics
        for name in self._cfgs:
            # materialise each shard's death counter at 0 now: a
            # counter born at its first increment has no 0 -> 1 delta,
            # so the shard-deaths burn rate could never see the death
            metrics.SHARD_DEATHS_TOTAL.labels(shard=name)
            self._spawn(name)
        self.wait_ready(timeout)
        if self._supervise:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog, daemon=True, name="shard-watchdog")
            self._watchdog_thread.start()

    def _spawn(self, name: str) -> None:
        p = self._ctx.Process(target=shard_worker_main,
                              args=(self._cfgs[name],),
                              name=name, daemon=True)
        p.start()
        self._procs[name] = p
        log.info("spawned %s pid=%d port=%d", name, p.pid,
                 self._cfgs[name]["port"])

    def wait_ready(self, timeout: float = 60.0,
                   names: list[str] | None = None) -> None:
        deadline = time.monotonic() + timeout
        for name in names or self.names:
            url = self.urls[name] + "/healthz"
            while True:
                try:
                    with urllib.request.urlopen(url, timeout=2) as r:
                        if r.status == 200:
                            break
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{name} never became healthy "
                                       f"at {url}")
                time.sleep(0.05)

    def kill(self, name: str) -> int:
        """SIGKILL one shard (the chaos verb). The watchdog — or an
        explicit ``respawn`` — brings it back at the same port + WAL
        directory, which is the whole point: recovery is replay, not
        re-provisioning."""
        p = self._procs[name]
        pid = p.pid
        os.kill(pid, signal.SIGKILL)
        p.join(timeout=10)
        return pid

    def respawn(self, name: str, timeout: float = 60.0) -> None:
        with self._lock:
            p = self._procs.get(name)
            if p is not None and p.is_alive():
                return
            self._spawn(name)
        self.wait_ready(timeout, names=[name])

    # ---- elastic membership (split / merge) --------------------------
    def add_shard(self, name: str | None = None,
                  timeout: float = 60.0) -> str:
        """Spawn one NEW shard (the split recipient): fresh name, fresh
        port, fresh (empty) WAL directory. Health-waited; the caller
        copies state into it and flips the ring afterwards."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        with self._lock:
            if name is None:
                name = f"shard-{self._next_index}"
                self._next_index += 1
            elif name in self._cfgs:
                raise ValueError(f"shard {name!r} already exists")
            if name in self._retired:
                # a re-admitted name must not replay its old store
                raise ValueError(f"shard {name!r} was retired; "
                                 "elastic names are never reused")
            cfg = self._make_cfg(name)
            metrics.SHARD_DEATHS_TOTAL.labels(shard=name)
            self._spawn(name)
        self.wait_ready(timeout, names=[name])
        log.info("elastic: added %s on port %d", name, cfg["port"])
        return name

    def remove_shard(self, name: str, timeout: float = 30.0) -> None:
        """Retire one shard DELIBERATELY (the merge donor, after its
        range has been handed off). The intentional-shutdown handshake:
        the name goes into ``_expected`` under the watchdog's own lock
        BEFORE the SIGTERM, so the watchdog never mistakes this exit
        for a death — no ``shard_deaths_total`` increment, no
        shard-death critical alert, no respawn. SIGTERM (not SIGKILL)
        lets the worker flush + close its WAL cleanly."""
        with self._lock:
            if name not in self._cfgs:
                raise KeyError(f"no shard {name!r}")
            self._expected.add(name)
            p = self._procs.pop(name, None)
            self._retired[name] = self._cfgs.pop(name)
        if p is not None and p.is_alive():
            p.terminate()
            p.join(timeout=timeout)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        with self._lock:
            self._expected.discard(name)
        log.info("elastic: retired %s", name)

    def _watchdog(self) -> None:
        from kubeflow_rm_tpu_torch.controlplane import chaos, metrics
        while not self._stopping:
            time.sleep(0.2)
            # seeded shard-SIGKILL: one chaos opportunity per watchdog
            # tick; the kill lands through the same ``kill`` verb the
            # explicit chaos test uses, and this very loop observes the
            # death and respawns in place
            alive = [n for n, p in list(self._procs.items())
                     if p.is_alive() and n not in self._expected]
            victim = chaos.shard_kill_victim(alive)
            if victim is not None and not self._stopping:
                log.warning("chaos: SIGKILLing %s", victim)
                try:
                    self.kill(victim)
                except (OSError, KeyError):
                    metrics.swallowed("shard.runner", "chaos kill")
            for name, p in list(self._procs.items()):
                if self._stopping or p.is_alive():
                    continue
                if name in self._expected:
                    # intentional-shutdown handshake: a deliberate
                    # scale-down in flight — not a death
                    continue
                exitcode = p.exitcode
                log.warning("%s exited (code %s); respawning in place",
                            name, exitcode)
                metrics.SHARD_DEATHS_TOTAL.labels(shard=name).inc()
                respawned = False
                with self._lock:
                    if not self._stopping and \
                            name in self._procs and \
                            not self._procs[name].is_alive():
                        self._spawn(name)
                        respawned = True
                if respawned and self._on_death is not None:
                    try:
                        self._on_death(name, exitcode)
                    except Exception:  # noqa: BLE001 - observer hook
                        # must never take the watchdog down with it
                        metrics.swallowed("shard.runner",
                                          "on_death hook")

    def stop(self) -> None:
        # under the watchdog's lock: a respawn it has begun lands in
        # ``_procs`` before the sweep below reads it, and none begins
        # after (JAX's copy sets the flag bare and iterates the live
        # map, so a respawn racing it outlives ``stop``: C15)
        with self._lock:
            self._stopping = True
            procs = list(self._procs.values())
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
