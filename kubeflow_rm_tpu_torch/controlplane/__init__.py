"""controlplane — the notebook platform's control plane on the port
(counterpart of ``kubeflow_rm_tpu/controlplane``, each module at the JAX
module's path and name).

Ported: the Notebook/Profile/PodDefault/Tensorboard/PVCViewer/TPUJob
resource model; the admission chain (the notebook webhook's
reconciliation lock, image resolution and no-restart guard, the pricer
(:mod:`.webhook.admission_pricer`), the PodDefault merge and the
card-slice rendezvous injection (:mod:`.webhook.gpu_inject`)); the
reconcilers that render card-slice StatefulSets (:mod:`.controllers.notebook`),
the auth companion, slice health, profiles with their card quotas,
idle culling, TensorBoard, the PVC viewer and TPUJob gangs; the fake
kubelet that gang-binds pods onto GPU nodes
(:mod:`.controllers.statefulset` over :mod:`.scheduler`); the in-memory
apiserver (:mod:`.apiserver`) with its write-ahead log and snapshots
(:mod:`.persistence`), the controller runtime (:mod:`.runtime`,
:mod:`.ha.workqueue`) with leader election (:mod:`.ha.leases`), the
shared informer cache (:mod:`.cache`) and Notebook/TPUJob version
conversion (:mod:`.api.conversion`); the suspend/resume lifecycle with
preemption, replica failover and compaction (:mod:`.suspend`), and card
harvesting for the serving fleet (:mod:`.harvest`).
Beside it: the seams into the compute path (the pricer, :mod:`.obs.slo`),
the serving gateway and fleet (:mod:`.webapps.serving`,
:mod:`.serving_fleet`), and the standard-library :mod:`.metrics` and
:mod:`.tracing`.

The rendered objects equal JAX's up to the accelerator vocabulary of
:mod:`.api.gpu` (``nvidia.com/gpu`` for ``google.com/tpu``, the GKE GPU
node labels, the ``h100-80gb-*`` slice types), the slice-health Event's
wording and a multi-host slice's NetworkPolicy (its pods reach one
another on every port: NCCL's are ephemeral). The env contract the pods
get is JAX's, names included (``TPU_WORKER_ID``, ``MEGASCALE_*``): the
port's launcher reads it.

The deployed layout (:mod:`.deploy`): the kube REST facade over an
apiserver, the kube adapter and its shard router over the hash ring
(:mod:`.shard.ring`; ``APIServer(shard=)`` names a shard), the admission
webhook server, the CRDs and the manifests; :func:`make_cluster_manager`
wires the platform's controllers over the adapter, one watch per kind of
:data:`WATCHED_KINDS`. The shard processes (:mod:`.shard`): one worker
process a shard (:mod:`.shard.worker`) under a supervisor that respawns a
killed shard in place from its WAL (:mod:`.shard.runner`), and the live
split/merge with its autoscaler (:mod:`.shard.elastic`).

The observability loop (:mod:`.obs`): the TSDB, the SLO engine, the
flight recorder and the Observer over the shards. The notebook-facing
web apps (:mod:`.webapps`): the standard-library WSGI kit
(:mod:`.webapps.core`: authn, authz, CSRF, probes, envelopes), the status
ladder, the readiness hub behind the spawner's long-poll, the Jupyter
spawner, volumes, TensorBoards and KFAM.

Not ported yet (ROADMAP slice 7f-2b): the dashboard, ``metrics_service``,
the SPA, the gateway and ``controlplane/__main__.py``, the entry point
the manifests' commands name.
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer


def make_control_plane(clock=None, *, auto_ready: bool = True,
                       enable_culling: bool = False,
                       culler_config=None, cache: bool = True,
                       global_lock: bool = False,
                       enable_suspend: bool = False,
                       suspend_config=None):
    """Build (api, manager) with every controller and webhook wired.

    ``clock`` is injectable for deterministic culling tests;
    ``auto_ready=False`` leaves scheduled pods un-Ready for status tests;
    ``cache=False`` runs the manager on the raw verb surface (the A/B
    baseline arm of ``spawn_conformance --no-cache``);
    ``global_lock=True`` restores the pre-r08 single-RLock apiserver
    with synchronous watch delivery (the ``--global-lock`` A/B arm);
    ``enable_suspend=True`` adds the suspend/resume lifecycle
    controller (``suspend_config`` → ``SuspendController`` kwargs, e.g.
    ``{"suspend_idle_minutes": 30}`` to park idle slices) and the
    replica failover controller, which shares its state store.
    """
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.api import poddefault as pd_api
    from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
    from kubeflow_rm_tpu_torch.controlplane.controllers.culling import (
        CullingController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.notebook import (
        NotebookController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.profile import (
        ProfileController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.pvcviewer import (
        PVCViewerController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        DeploymentController,
        StatefulSetController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.tensorboard import (
        TensorboardController,
    )
    from kubeflow_rm_tpu_torch.controlplane.runtime import Manager
    from kubeflow_rm_tpu_torch.controlplane.webhook.notebook import (
        LockReleaseController,
        NotebookWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.poddefault import (
        PodDefaultWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.gpu_inject import (
        GpuInjectWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
        AdmissionPricer,
    )

    api = APIServer(global_lock=global_lock,
                    **({"clock": clock} if clock else {}))
    api.register_validator(nb_api.KIND, nb_api.validate)
    api.register_validator(pd_api.KIND, pd_api.validate)
    api.register_validator(tj_api.KIND, tj_api.validate)

    # admission order: notebook webhook on Notebooks (the pricer runs
    # after it so a priced status survives the lock injection); for
    # pods, the PodDefault merge runs before card injection (injection
    # must see the final container set, sidecars included)
    NotebookWebhook(api).register()
    AdmissionPricer(api).register()
    PodDefaultWebhook(api).register()
    GpuInjectWebhook(api).register()

    from kubeflow_rm_tpu_torch.controlplane.controllers.authcompanion import (
        AuthCompanionController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.slicehealth import (
        SliceHealthController,
    )

    # the Manager (and through it every controller) reads through the
    # shared informer cache; the raw api is returned so tests and web
    # apps keep their direct handle on the backing store. The informer
    # registers its watcher BEFORE the Manager's, so the store is
    # already updated when a reconcile fires for an event.
    from kubeflow_rm_tpu_torch.controlplane.cache import CachedAPI
    from kubeflow_rm_tpu_torch.controlplane.controllers.tpujob import (
        TPUJobController,
    )
    manager = Manager(CachedAPI(api) if cache else api)
    manager.add(NotebookController())
    manager.add(TPUJobController())
    manager.add(LockReleaseController())
    manager.add(AuthCompanionController())
    manager.add(SliceHealthController())
    manager.add(StatefulSetController(auto_ready=auto_ready))
    manager.add(DeploymentController(auto_ready=auto_ready))
    manager.add(ProfileController())
    manager.add(TensorboardController())
    manager.add(PVCViewerController())
    if enable_culling:
        manager.add(CullingController(**(culler_config or {})))
    if enable_suspend:
        from kubeflow_rm_tpu_torch.controlplane.suspend import (
            ReplicaFailoverController,
            SuspendController,
        )
        manager.add(SuspendController(**(suspend_config or {})))
        # replicated kernels ride the same suspend/resume primitive:
        # failover = demand-resume from the warm checkpoint, so the
        # controller ships (and shares a store) with the lifecycle
        manager.add(ReplicaFailoverController(
            store=(suspend_config or {}).get("store")))
    return api, manager


def make_cluster_manager(api, *, enable_culling: bool = True,
                         culler_config=None,
                         enable_suspend: bool = False,
                         suspend_config=None):
    """Controller wiring for a REAL cluster (``deploy.kubeclient``):
    same reconcilers as ``make_control_plane`` minus the pieces a real
    cluster provides itself — the StatefulSet/Deployment controllers
    (kube-controller-manager + kubelet) and the admission webhooks
    (served over HTTPS by ``deploy.webhook_server`` instead).

    Equivalent of the reference's manager processes
    (``notebook-controller/main.go:58-148`` + odh + profile + tb +
    pvcviewer managers, collapsed into one here).
    """
    from kubeflow_rm_tpu_torch.controlplane.controllers.authcompanion import (
        AuthCompanionController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.culling import (
        CullingController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.notebook import (
        NotebookController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.profile import (
        ProfileController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.pvcviewer import (
        PVCViewerController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.slicehealth import (
        SliceHealthController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.tensorboard import (
        TensorboardController,
    )
    from kubeflow_rm_tpu_torch.controlplane.runtime import Manager
    from kubeflow_rm_tpu_torch.controlplane.webhook.notebook import (
        LockReleaseController,
    )

    from kubeflow_rm_tpu_torch.controlplane.cache import CachedAPI
    from kubeflow_rm_tpu_torch.controlplane.controllers.tpujob import (
        TPUJobController,
    )
    if not isinstance(api, CachedAPI):
        # against the kube adapter this adopts the adapter's informer-
        # fed ObjectStore (one cache, two consumers); reads stay
        # fall-through until the watch threads sync each kind
        api = CachedAPI(api)
    manager = Manager(api)
    manager.add(NotebookController())
    manager.add(TPUJobController())
    manager.add(LockReleaseController())
    manager.add(AuthCompanionController())
    manager.add(SliceHealthController())
    manager.add(ProfileController())
    manager.add(TensorboardController())
    manager.add(PVCViewerController())
    if enable_culling:
        manager.add(CullingController(**(culler_config or {})))
    if enable_suspend:
        from kubeflow_rm_tpu_torch.controlplane.suspend import (
            ReplicaFailoverController,
            SuspendController,
        )
        manager.add(SuspendController(**(suspend_config or {})))
        manager.add(ReplicaFailoverController(
            store=(suspend_config or {}).get("store")))
    return manager


# kinds the cluster manager watches (one watch thread per kind)
WATCHED_KINDS = (
    "Notebook", "TPUJob", "Profile", "Tensorboard", "PVCViewer",
    "StatefulSet", "Deployment", "Service", "Pod", "Event",
    # owned satellite kinds: controller-runtime's Owns() starts an
    # informer per owned type, which is what lets the cached client
    # serve reconcile_child's try_get-before-create from memory —
    # without these, every satellite read is a live GET and the
    # 20-way spawn storm goes apiserver-bound
    "Secret", "ServiceAccount", "ConfigMap", "RoleBinding",
    "NetworkPolicy", "VirtualService", "Route", "ResourceQuota",
    "Namespace", "Node", "AuthorizationPolicy",
    "PersistentVolumeClaim", "PodDefault",
)
