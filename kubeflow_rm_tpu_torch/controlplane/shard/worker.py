"""One control-plane shard, as a process (the port's copy of
``kubeflow_rm_tpu/controlplane/shard/worker.py``).

A shard is the full single-host stack scoped to its ring partition:
the in-memory apiserver (optionally WAL-backed) with admission +
validation registered, the fake-kubelet manager marking pods Ready,
the kube REST facade on a FIXED port (the ring maps namespaces to
URLs, so a respawned shard must come back at the same address), and
the platform controller manager reconciling through a loopback kube
client — gated on a short-duration ``LeaderElector`` lease stored in
the shard's own store, so a respawn after SIGKILL takes over within
one lease duration instead of double-reconciling against a zombie.

``shard_worker_main`` is the ``multiprocessing`` (spawn) entry point;
everything it needs arrives in one picklable config dict. A shard is
host code: it makes no CUDA call, so it never holds a context on a card.
"""

from __future__ import annotations

import logging
import os
import signal
import threading

log = logging.getLogger("kubeflow_rm_tpu_torch.shard.worker")

# short lease: sole-candidate acquisition is immediate, and a respawn
# after SIGKILL steals the dead holder's lease in ~one duration — the
# default 15s would dominate the chaos-recovery time budget
LEASE_DURATION_S = 3.0
LEASE_RENEW_S = 2.0
LEASE_RETRY_S = 0.5


def shard_worker_main(cfg: dict) -> None:
    """Boot one shard and serve forever (the runner SIGKILLs us).

    ``cfg``: name, port, wal_dir (None = no WAL), manager_workers,
    auto_ready, hang_dump_s, tracing.
    """
    logging.basicConfig(level=logging.WARNING)
    if cfg.get("hang_dump_s"):
        import faulthandler
        faulthandler.dump_traceback_later(cfg["hang_dump_s"], exit=True)

    from kubeflow_rm_tpu_torch.controlplane import (
        WATCHED_KINDS,
        make_cluster_manager,
        metrics,
    )
    from kubeflow_rm_tpu_torch.controlplane.api import meta
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.api import poddefault as pd_api
    from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        DeploymentController,
        StatefulSetController,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import (
        KubeAPIServer,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy.restserver import (
        RestServer,
    )
    from kubeflow_rm_tpu_torch.controlplane.ha.leases import LeaderElector
    from kubeflow_rm_tpu_torch.controlplane.runtime import Manager
    from kubeflow_rm_tpu_torch.controlplane.webhook.gpu_inject import (
        GpuInjectWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.notebook import (
        NotebookWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.poddefault import (
        PodDefaultWebhook,
    )

    name = cfg["name"]
    metrics.set_shard(name)
    if cfg.get("tracing"):
        from kubeflow_rm_tpu_torch.controlplane import tracing
        tracing.set_enabled(True)
        # spans carry this so cross-shard merges can show which
        # process each hop ran in
        tracing.set_process(name)
    stop = threading.Event()

    # -- the shard's cluster: apiserver (+WAL) + admission + kubelet --
    capi = APIServer(wal_dir=cfg.get("wal_dir"), shard=name)
    # this process counts uids from 1: move past every uid the recovered
    # store holds, or a respawned shard mints them again (C16; JAX's
    # worker does)
    meta.reserve_uids((o.get("metadata") or {}).get("uid")
                      for objs in capi._by_kind.values()
                      for o in objs.values())
    capi.register_validator(nb_api.KIND, nb_api.validate)
    capi.register_validator(pd_api.KIND, pd_api.validate)
    NotebookWebhook(capi).register()
    PodDefaultWebhook(capi).register()
    GpuInjectWebhook(capi).register()
    kubelet = Manager(capi)
    kubelet.add(StatefulSetController(
        auto_ready=cfg.get("auto_ready", True)))
    kubelet.add(DeploymentController(
        auto_ready=cfg.get("auto_ready", True)))
    # after WAL replay some StatefulSets may have landed without their
    # pods (killed mid-fan-out): requeue everything once on boot
    kubelet.enqueue_all()
    threading.Thread(target=kubelet.run_forever, args=(stop, 0.05),
                     kwargs={"workers": 4}, daemon=True).start()

    # a deliberate scale-down (ShardRunner.remove_shard) SIGTERMs us:
    # flush + close the WAL so the merge coordinator reads a cleanly
    # closed log (SIGKILL stays crash-consistent via group commit —
    # this handler is an optimization, not a correctness requirement)
    def _graceful_exit(signum, frame):
        stop.set()
        try:
            capi.close_persistence()
        finally:
            os._exit(0)

    signal.signal(signal.SIGTERM, _graceful_exit)

    rest = RestServer(capi, port=cfg["port"])
    rest.start()

    # lease namespace for the elector below (shard-local control ns)
    capi.ensure_namespace("kubeflow")

    # -- the shard's platform manager over a loopback kube client --
    kapi = KubeAPIServer(rest.url, identity=f"manager-{name}",
                         cache_reads=True)
    mgr = make_cluster_manager(kapi, enable_culling=False)
    for kind in WATCHED_KINDS:
        threading.Thread(target=kapi.watch_kind,
                         args=(kind, None, stop, 60),
                         daemon=True).start()
    elector = LeaderElector(
        kapi, identity=f"{name}-{os.getpid()}",
        lease_name=f"controlplane-manager-{name}",
        lease_duration_s=LEASE_DURATION_S,
        renew_deadline_s=LEASE_RENEW_S,
        retry_period_s=LEASE_RETRY_S)
    mgr.enqueue_all()
    log.info("shard %s serving on port %d (wal=%s)", name,
             cfg["port"], bool(cfg.get("wal_dir")))
    # blocks until the process is killed
    mgr.run_forever(stop, 0.05,
                    workers=cfg.get("manager_workers", 8),
                    elector=elector)
