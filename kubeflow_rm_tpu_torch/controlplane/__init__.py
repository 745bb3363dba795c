"""controlplane — the notebook platform's control plane on the port
(counterpart of ``kubeflow_rm_tpu/controlplane``, each module at the JAX
module's path and name).

Ported so far is the spawn path: a Notebook CR is validated, priced at
admission (:mod:`.webhook.admission_pricer`), rendered to a card-slice
StatefulSet and its Services (:mod:`.controllers.notebook`), realised
into ordinal Pods that the rendezvous webhook injects
(:mod:`.webhook.gpu_inject`) and the fake kubelet gang-binds onto GPU
nodes (:mod:`.controllers.statefulset` over :mod:`.scheduler`), all on
the in-memory apiserver (:mod:`.apiserver`) and the controller runtime
(:mod:`.runtime`, :mod:`.ha.workqueue`). Beside it: the seams into the
compute path (the pricer, :mod:`.obs.slo`), the serving gateway and
fleet (:mod:`.webapps.serving`, :mod:`.serving_fleet`), and the
standard-library :mod:`.metrics` and :mod:`.tracing`.

The rendered objects equal JAX's up to the accelerator vocabulary of
:mod:`.api.gpu` (``nvidia.com/gpu`` for ``google.com/tpu``, the GKE GPU
node labels, the ``h100-80gb-*`` slice types). The env contract the pods
get is JAX's, names included (``TPU_WORKER_ID``, ``MEGASCALE_*``): the
port's launcher reads it.

Not ported yet, and refused where the spawn path meets them: the
informer cache (``make_control_plane(cache=True)``), culling,
suspend/resume (``enable_suspend``, ``suspend.set_oversubscribe(True)``),
the WAL and shards (``APIServer(wal_dir=, shard=)``), leader election,
the notebook/PodDefault webhooks, the profile, slice-health and TPUJob
controllers and the web apps (ROADMAP slices 7b-7f).
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer


def make_control_plane(clock=None, *, auto_ready: bool = True,
                       enable_culling: bool = False,
                       culler_config=None, cache: bool = True,
                       global_lock: bool = False,
                       enable_suspend: bool = False,
                       suspend_config=None):
    """Build (api, manager) with the spawn path's controllers and
    webhooks wired.

    ``clock`` is injectable for deterministic tests; ``auto_ready=False``
    leaves scheduled pods un-Ready for status tests; ``global_lock=True``
    restores the single-RLock apiserver with synchronous watch delivery.
    ``cache=True`` (JAX's default: the manager reads through the informer
    cache), ``enable_culling`` and ``enable_suspend`` raise
    ``NotImplementedError`` until their slices land: pass ``cache=False``.
    """
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
    from kubeflow_rm_tpu_torch.controlplane.controllers.notebook import (
        NotebookController,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        DeploymentController,
        StatefulSetController,
    )
    from kubeflow_rm_tpu_torch.controlplane.runtime import Manager
    from kubeflow_rm_tpu_torch.controlplane.webhook.gpu_inject import (
        GpuInjectWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
        AdmissionPricer,
    )

    if cache:
        raise NotImplementedError(
            "make_control_plane(cache=True): the informer cache "
            "(controlplane/cache) is not ported yet — ROADMAP slice 7c; "
            "pass cache=False (the manager on the raw verb surface)")
    if enable_culling:
        raise NotImplementedError(
            "make_control_plane(enable_culling=True): idle culling is not "
            "ported yet — ROADMAP slice 7b")
    if enable_suspend:
        raise NotImplementedError(
            "make_control_plane(enable_suspend=True): suspend/resume is "
            "not ported yet — ROADMAP slice 7d")

    api = APIServer(global_lock=global_lock,
                    **({"clock": clock} if clock else {}))
    api.register_validator(nb_api.KIND, nb_api.validate)
    api.register_validator(tj_api.KIND, tj_api.validate)

    # admission order: the pricer on Notebooks; on pods, card injection
    # (the notebook and PodDefault webhooks that run around them in JAX's
    # chain wait for slice 7b)
    AdmissionPricer(api).register()
    GpuInjectWebhook(api).register()

    manager = Manager(api)
    manager.add(NotebookController())
    manager.add(StatefulSetController(auto_ready=auto_ready))
    manager.add(DeploymentController(auto_ready=auto_ready))
    return api, manager
