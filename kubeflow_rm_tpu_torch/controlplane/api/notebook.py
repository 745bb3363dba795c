"""Notebook resource: the platform's primary API object.

Shape (mirrors the reference CRD — a Notebook wraps a full pod template,
``notebook-controller/api/v1beta1/notebook_types.go:27-34`` — plus the
TPU-native ``spec.tpu`` block that is this framework's reason to exist):

    apiVersion: kubeflow.org/v1
    kind: Notebook
    metadata: {name, namespace, labels, annotations}
    spec:
      template:
        spec:            # pod spec: containers[], volumes[], ...
      tpu:               # optional — absent means a CPU notebook
        acceleratorType: h100-80gb-2x4   # a slice type of api/gpu.py
    status:
      conditions: [...]
      readyReplicas: N
      containerState: {...}

Behavior annotations keep the reference's names (the *annotations* are
the real control API — SURVEY.md §2.7), with TPU additions under the
``notebooks.kubeflow.org/`` prefix.
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get, make_object

API_VERSION = "kubeflow.org/v1"
KIND = "Notebook"

# --- behavior annotations (reference names, pkg/culler/culler.go:40-41,
# notebook_controller.go:51-53, jupyter .../form.py:10) ----------------
STOP_ANNOTATION = "kubeflow-resource-stopped"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
REWRITE_URI_ANNOTATION = "notebooks.kubeflow.org/http-rewrite-uri"
HEADERS_ANNOTATION = "notebooks.kubeflow.org/http-headers-request-set"
RESTART_ANNOTATION = "notebooks.kubeflow.org/notebook-restart"
SERVER_TYPE_ANNOTATION = "notebooks.kubeflow.org/server-type"
CULLING_EXCLUDE_ANNOTATION = "kubeflow-resource-culling-excluded"

# TPU-native additions
TPU_INJECT_EXCLUDE_ANNOTATION = "notebooks.kubeflow.org/tpu-inject-exclude"

# --- suspend/resume lifecycle (controlplane/suspend.py) ---------------
# Distinct from STOP_ANNOTATION: a *stopped* notebook stays down until a
# user restarts it; a *suspended* one released its chips to the pool and
# transparently resumes on the next incoming request. Value = ISO
# timestamp of the suspend decision (drives per-phase latency metrics).
SUSPEND_ANNOTATION = "notebooks.kubeflow.org/suspended"
# why the slice was parked: "idle" | "preempted" | "api"
SUSPEND_REASON_ANNOTATION = "notebooks.kubeflow.org/suspend-reason"
# JSON token from the Checkpointer-backed state store, written at
# suspend time; resume restores against it and stamps restored-step
SUSPEND_CHECKPOINT_ANNOTATION = "notebooks.kubeflow.org/suspend-checkpoint"
# ISO timestamp the slice finished draining (set once per suspend cycle)
SUSPEND_DRAINED_ANNOTATION = "notebooks.kubeflow.org/suspend-drained"
# ISO timestamp of the first resume-triggering request (earliest wins —
# the suspend→resume latency clock starts here)
RESUME_REQUESTED_ANNOTATION = "notebooks.kubeflow.org/resume-requested"
# step the state store restored on the last resume (proof of exactness)
RESTORED_STEP_ANNOTATION = "notebooks.kubeflow.org/restored-step"
# the workload's durable training step (maintained by the in-notebook
# launcher agent; the state store snapshots it at suspend time)
TRAINING_STEP_ANNOTATION = "notebooks.kubeflow.org/training-step"
# pin: never suspend, never select as a preemption victim, never cull
PIN_ANNOTATION = "tpu.kubeflow.org/do-not-suspend"

# --- replicated kernels (NotebookOS): spec.replicas standbys ----------
# With ``spec.replicas: R`` > 1 one replica is *active* (holds the
# chips); R-1 are parked CPU-only standbys kept warm through the
# checkpoint state store. The failover controller owns these:
# which replica id currently holds the chips (int as str)
ACTIVE_REPLICA_ANNOTATION = "tpu.kubeflow.org/active-replica"
# JSON {replica_id: "active" | "standby" | "promoting"}
REPLICA_STATES_ANNOTATION = "tpu.kubeflow.org/replica-states"
# JSON checkpoint token standbys keep warm (refreshed as the active
# replica's durable training step advances — what a promotion restores)
WARM_CHECKPOINT_ANNOTATION = "tpu.kubeflow.org/warm-checkpoint"
# ISO timestamp the active replica's death was detected (failover
# latency clock; popped when the promotion completes)
FAILOVER_T0_ANNOTATION = "tpu.kubeflow.org/failover-t0"

# --- live migration (checkpoint -> drain -> re-bind elsewhere) --------
# JSON list of node names the rebind must avoid (the nodes the slice
# occupied when the migration was initiated)
MIGRATE_EXCLUDE_ANNOTATION = "tpu.kubeflow.org/migrate-exclude-nodes"
# ISO timestamp of the migration request; while present the drain
# auto-resumes instead of parking (popped when the re-bind completes)
MIGRATE_REQUESTED_ANNOTATION = "tpu.kubeflow.org/migrate-requested"

#: the lifecycle phase a drained suspended notebook reports
SUSPENDED_PHASE = "Suspended"

#: named priority classes for spec.priorityClassName; higher wins.
#: Absent spec → "default", so pre-oversubscription notebooks neither
#: preempt nor outrank anything they didn't before.
PRIORITY_CLASSES = {"low": 0, "default": 100, "high": 1000}
DEFAULT_PRIORITY = PRIORITY_CLASSES["default"]

# label the controller stamps on everything it renders
NOTEBOOK_NAME_LABEL = "notebook-name"
# pod label carrying the slice's accelerator type (webhook + web apps read it)
TPU_ACCELERATOR_LABEL = "notebooks.kubeflow.org/tpu-accelerator-type"
# pod label carrying the multislice width (>1 ⇒ DCN job; webhook
# injects MEGASCALE_* rendezvous from it)
TPU_NUM_SLICES_LABEL = "notebooks.kubeflow.org/tpu-num-slices"


def make_notebook(name: str, namespace: str, *,
                  image: str = "jupyter-jax:latest",
                  accelerator_type: str | None = None,
                  num_slices: int = 1,
                  priority_class: str | None = None,
                  replicas: int | None = None,
                  labels: dict | None = None,
                  annotations: dict | None = None,
                  pod_spec_extra: dict | None = None,
                  container_extra: dict | None = None) -> dict:
    """Convenience constructor used by tests and the spawner backend."""
    container = {
        "name": name,
        "image": image,
        "ports": [{"containerPort": 8888, "name": "notebook-port",
                   "protocol": "TCP"}],
    }
    if container_extra:
        container.update(container_extra)
    pod_spec: dict = {"containers": [container]}
    if pod_spec_extra:
        pod_spec.update(pod_spec_extra)
    spec: dict = {"template": {"spec": pod_spec}}
    if accelerator_type is not None:
        spec["tpu"] = {"acceleratorType": accelerator_type}
        if num_slices != 1:
            spec["tpu"]["numSlices"] = num_slices
    if priority_class is not None:
        spec["priorityClassName"] = priority_class
    if replicas is not None:
        spec["replicas"] = replicas
    return make_object(API_VERSION, KIND, name, namespace,
                       labels=labels, annotations=annotations, spec=spec)


def tpu_spec(notebook: dict) -> gpu_api.SliceTopology | None:
    """Resolve spec.tpu to a SliceTopology (None for CPU notebooks)."""
    t = deep_get(notebook, "spec", "tpu")
    if not t:
        return None
    return gpu_api.lookup(t["acceleratorType"])


#: schema-level cap on multislice width — one request may render at most
#: hosts-per-slice × MAX_SLICES pods, so an unbounded value would let a
#: single authenticated POST fan the controller out arbitrarily wide
MAX_SLICES = 64


def num_slices(notebook: dict) -> int:
    """Multislice width (1 = a single ICI-connected slice; >1 = a DCN
    job of identical slices, rendered as one gang-scheduled pool)."""
    return int(deep_get(notebook, "spec", "tpu", "numSlices", default=1))


def total_hosts(notebook: dict) -> int:
    """Pods the notebook renders to: hosts-per-slice × numSlices."""
    topo = tpu_spec(notebook)
    if topo is None:
        return 1
    return topo.hosts * num_slices(notebook)


#: schema-level cap on kernel replication width — each extra replica is
#: one parked CPU-only standby pod; past a handful the marginal
#: availability gain is zero while the pod fan-out is linear
MAX_REPLICAS = 8


def replicas_of(notebook: dict) -> int:
    """Scheduling-replica count (NotebookOS ``R``): 1 means the classic
    single-kernel notebook; R > 1 keeps R-1 warm CPU standbys."""
    try:
        return max(1, int(deep_get(notebook, "spec", "replicas",
                                   default=1)))
    except (TypeError, ValueError):
        return 1


def priority_of(notebook: dict) -> int:
    """Effective scheduling priority: an explicit integer
    ``spec.priority`` wins; else ``spec.priorityClassName`` resolved
    through PRIORITY_CLASSES; else DEFAULT_PRIORITY. Preemption only
    ever displaces a *strictly lower* priority, so all-default fleets
    keep today's first-come-first-served behavior."""
    p = deep_get(notebook, "spec", "priority")
    if p is not None:
        try:
            return int(p)
        except (TypeError, ValueError):
            return DEFAULT_PRIORITY
    cls = deep_get(notebook, "spec", "priorityClassName")
    return PRIORITY_CLASSES.get(cls, DEFAULT_PRIORITY)


def is_pinned(notebook: dict) -> bool:
    """Pinned notebooks hold their slice for the notebook's lifetime:
    skipped by idle culling, idle suspension, and preemption victim
    selection. Presence-based like the stop annotation (any value but
    an explicit \"false\")."""
    ann = (notebook["metadata"].get("annotations") or {})
    if PIN_ANNOTATION not in ann:
        return False
    return str(ann.get(PIN_ANNOTATION)).lower() != "false"


def validate(notebook: dict) -> None:
    """Structural validation (the CRD schema's job in the reference)."""
    containers = deep_get(notebook, "spec", "template", "spec", "containers")
    if not containers:
        raise ValueError("notebook spec.template.spec.containers must be "
                         "non-empty")
    t = deep_get(notebook, "spec", "tpu")
    if t is not None:
        if "acceleratorType" not in t:
            raise ValueError("spec.tpu requires acceleratorType")
        gpu_api.lookup(t["acceleratorType"])  # raises on unknown
        ns = t.get("numSlices", 1)
        if not isinstance(ns, int) or ns < 1 or ns > MAX_SLICES:
            raise ValueError(
                f"spec.tpu.numSlices must be an int in [1, {MAX_SLICES}]")
    cls = deep_get(notebook, "spec", "priorityClassName")
    if cls is not None and cls not in PRIORITY_CLASSES:
        raise ValueError(
            f"spec.priorityClassName must be one of "
            f"{sorted(PRIORITY_CLASSES)}, got {cls!r}")
    p = deep_get(notebook, "spec", "priority")
    if p is not None and not isinstance(p, int):
        raise ValueError("spec.priority must be an integer")
    r = deep_get(notebook, "spec", "replicas")
    if r is not None and (not isinstance(r, int) or r < 1
                          or r > MAX_REPLICAS):
        raise ValueError(
            f"spec.replicas must be an int in [1, {MAX_REPLICAS}]")
