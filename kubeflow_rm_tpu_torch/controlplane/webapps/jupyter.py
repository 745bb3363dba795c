"""Jupyter web app backend — the card-slice spawner (the port's copy of
``kubeflow_rm_tpu/controlplane/webapps/jupyter.py``).

Behavioral mirror of the reference JWA backend
(``crud-web-apps/jupyter/backend``): the spawner-config contract with
``{value, readOnly, options}`` enforced server-side (``form.py:15-59``),
form→Notebook-CR assembly (``form.py:74-299``,
``routes/post.py:12-75``), start/stop via the stop annotation, the
status ladder, and accelerator discovery — where the reference
intersects node capacity keys with configured GPU vendor limitsKeys
(``routes/get.py:101-126``), ``/api/tpus`` intersects the config's
slice presets with the cluster's live GPU node inventory, so the
picker only offers obtainable slices.

Slice differences by design:
- one ``tpu.acceleratorType`` field replaces {vendor, num}: cards,
  hosts, nodeSelectors, and rendezvous env are derived downstream
  (controller + webhook), never chosen by the user;
- ``/dev/shm`` stays (reference ``form.py:264-276``) for host-local
  torch dataloaders and NCCL's shared-memory transport.

The routes and JSON field names are JAX's (``/api/tpus``, the body's
``tpu.acceleratorType`` and ``numSlices``, ``chips``/``hosts``/
``topology`` in the answers: the Notebook keeps ``spec.tpu``); the
values are :mod:`..api.gpu`'s (``chips`` is a slice's card count). A
GPU node's labels name one host's shape (its accelerator and card
count), which every slice type of that host shape shares, so
``/api/tpus`` offers each configured type whose host shape some node
has. The spawner config (``spawner_ui_config.json``) is JAX's
``spawner_ui_config.yaml`` as JSON, with the port's slice types in
``tpu.options``: the image picker's options, the ``{value, readOnly,
options}`` contract (reference ``form.py:15-59``: readOnly fields
reject client-supplied values) and the toleration groups are JAX's.
"""

from __future__ import annotations

import copy
import json
import os

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane import suspend as suspend_mod
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of, deep_get, fast_deepcopy, set_annotation,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
from kubeflow_rm_tpu_torch.controlplane.webapps import status as status_mod
from kubeflow_rm_tpu_torch.controlplane.webapps.core import WebApp, json_body
from kubeflow_rm_tpu_torch.controlplane.webapps.readiness import ReadinessHub
from kubeflow_rm_tpu_torch.controlplane.webapps.serving import HTTPError

DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__),
                              "spawner_ui_config.json")


def load_spawner_config(path: str | None = None) -> dict:
    with open(path or DEFAULT_CONFIG) as f:
        return json.load(f)["spawnerFormDefaults"]


def get_form_value(body: dict, defaults: dict, body_field: str,
                   defaults_field: str | None = None, optional: bool = False):
    """readOnly-aware form value resolution (reference form.py:15-59)."""
    defaults_field = defaults_field or body_field
    user_value = body.get(body_field)
    if defaults_field not in defaults:
        return user_value
    entry = defaults[defaults_field]
    if entry.get("readOnly", False):
        if body_field in body:
            raise HTTPError(
                400, f"'{body_field}' is readonly but a value was "
                     f"provided: {user_value}")
        return entry["value"]
    if user_value is None:
        if not optional:
            raise HTTPError(400, f"No value provided for: {body_field}")
        return None
    return user_value


# --- form setters (reference form.py:74-299, slice-adapted) -----------

def _container(nb: dict) -> dict:
    return nb["spec"]["template"]["spec"]["containers"][0]


def set_image(nb: dict, body: dict, defaults: dict) -> None:
    """Image resolution per server type (reference form.py set_image):
    jupyter reads ``image``, group-one ``imageGroupOne`` (codeserver),
    group-two ``imageGroupTwo`` (rstudio); ``customImage`` overrides
    any of them subject to the base field's readOnly."""
    server_type = body.get("serverType") or deep_get(
        defaults, "serverType", "value", default="jupyter")
    group_field = {"group-one": "imageGroupOne",
                   "group-two": "imageGroupTwo"}.get(server_type, "image")
    if body.get("customImage"):
        image = get_form_value(body, defaults, "customImage", group_field)
    else:
        image = get_form_value(body, defaults, group_field)
    _container(nb)["image"] = image.strip()
    policy = get_form_value(body, defaults, "imagePullPolicy")
    _container(nb)["imagePullPolicy"] = policy


def set_server_type(nb: dict, body: dict, defaults: dict) -> None:
    valid = ("jupyter", "group-one", "group-two")
    server_type = get_form_value(body, defaults, "serverType") or "jupyter"
    if server_type not in valid:
        raise HTTPError(400, f"'{server_type}' is not a valid server type")
    set_annotation(nb, nb_api.SERVER_TYPE_ANNOTATION, server_type)
    if server_type in ("group-one", "group-two"):
        set_annotation(nb, nb_api.REWRITE_URI_ANNOTATION, "/")


def _reject_nan(value: str, what: str) -> None:
    if value and "nan" in value.lower():
        raise HTTPError(400, f"Invalid value for {what}: {value}")


def set_cpu(nb: dict, body: dict, defaults: dict) -> None:
    cpu = get_form_value(body, defaults, "cpu")
    _reject_nan(cpu, "cpu")
    limit = get_form_value(body, defaults, "cpuLimit", optional=True)
    _reject_nan(limit or "", "cpu limit")
    factor = defaults.get("cpu", {}).get("limitFactor", "none")
    if not limit and factor != "none":
        limit = str(round(float(cpu) * float(factor), 1))
    res = _container(nb).setdefault("resources", {})
    res.setdefault("requests", {})["cpu"] = cpu
    if limit:
        if float(limit) < float(cpu):
            raise HTTPError(400,
                            "CPU limit must be greater than the request")
        res.setdefault("limits", {})["cpu"] = limit


def set_memory(nb: dict, body: dict, defaults: dict) -> None:
    memory = get_form_value(body, defaults, "memory")
    _reject_nan(memory, "memory")
    limit = get_form_value(body, defaults, "memoryLimit", optional=True)
    _reject_nan(limit or "", "memory limit")
    factor = defaults.get("memory", {}).get("limitFactor", "none")
    if not limit and factor != "none":
        limit = str(round(float(memory.replace("Gi", "")) * float(factor),
                          1)) + "Gi"
    res = _container(nb).setdefault("resources", {})
    res.setdefault("requests", {})["memory"] = memory
    if limit:
        if float(limit.replace("Gi", "")) < float(memory.replace("Gi", "")):
            raise HTTPError(400,
                            "Memory limit must be greater than the request")
        res.setdefault("limits", {})["memory"] = limit


def set_tpu(nb: dict, body: dict, defaults: dict) -> None:
    """The reference's set_notebook_gpus seam (form.py:226-250), slice
    shape: a single acceleratorType names the whole slice."""
    tpu = get_form_value(body, defaults, "tpu")
    if not tpu:
        return
    accel = tpu.get("acceleratorType", "none")
    if accel == "none":
        return
    try:
        topo = gpu_api.lookup(accel)
    except gpu_api.UnknownAcceleratorType as e:
        raise HTTPError(400, str(e))
    allowed = defaults.get("tpu", {}).get("options")
    if allowed and accel not in allowed:
        raise HTTPError(
            400, f"acceleratorType {accel!r} is not offered by this "
                 f"deployment's spawner config")
    nb["spec"]["tpu"] = {"acceleratorType": topo.accelerator_type}
    # multislice: N slices in one world (the MEGASCALE_* rendezvous
    # comes from the webhook; the controller renders hosts x N pods)
    num_slices = tpu.get("numSlices", 1)
    if (not isinstance(num_slices, int) or num_slices < 1
            or num_slices > nb_api.MAX_SLICES):
        raise HTTPError(
            400, f"tpu.numSlices must be an int in "
                 f"[1, {nb_api.MAX_SLICES}], got {num_slices!r}")
    if num_slices > 1:
        nb["spec"]["tpu"]["numSlices"] = num_slices


def set_tolerations(nb: dict, body: dict, defaults: dict) -> None:
    key = get_form_value(body, defaults, "tolerationGroup")
    if key == "none":
        return
    for group in defaults.get("tolerationGroup", {}).get("options", []):
        if group.get("groupKey") == key:
            spec = nb["spec"]["template"]["spec"]
            spec.setdefault("tolerations", []).extend(group["tolerations"])
            return
    raise HTTPError(400,
                    f"No Toleration Group with key {key!r} in the config")


def set_affinity(nb: dict, body: dict, defaults: dict) -> None:
    key = get_form_value(body, defaults, "affinityConfig")
    if key == "none":
        return
    for cfg in defaults.get("affinityConfig", {}).get("options", []):
        if cfg.get("configKey") == key:
            nb["spec"]["template"]["spec"]["affinity"] = cfg["affinity"]
            return
    raise HTTPError(400,
                    f"No Affinity Config with key {key!r} in the config")


def set_configurations(nb: dict, body: dict, defaults: dict) -> None:
    labels = get_form_value(body, defaults, "configurations")
    if not isinstance(labels, list):
        raise HTTPError(400,
                        f"Labels for PodDefaults are not list: {labels}")
    for label in labels:
        nb["metadata"].setdefault("labels", {})[label] = "true"


def set_shm(nb: dict, body: dict, defaults: dict) -> None:
    if not get_form_value(body, defaults, "shm"):
        return
    spec = nb["spec"]["template"]["spec"]
    spec.setdefault("volumes", []).append(
        {"name": "dshm", "emptyDir": {"medium": "Memory"}})
    _container(nb).setdefault("volumeMounts", []).append(
        {"mountPath": "/dev/shm", "name": "dshm"})


def set_environment(nb: dict, body: dict, defaults: dict) -> None:
    env = get_form_value(body, defaults, "environment") or {}
    if isinstance(env, str):
        env = json.loads(env) if env else {}
    _container(nb).setdefault("env", []).extend(
        {"name": k, "value": str(v)} for k, v in env.items())


def _mount_volume(ns: str, nb: dict, vol: dict) -> dict | None:
    """Phase 1 of a workspace/data volume: fold the mount into the
    template WITHOUT side effects; returns the PVC object to create
    (phase 2) for newPvc volumes. Split so the PodDefault dry-run can
    validate the FULL pod shape (mounts included) before any PVC
    exists — a rejected spawn must leave nothing behind."""
    mount = vol.get("mount")
    if not mount:
        raise HTTPError(400, "volume requires a 'mount' path")
    pvc_to_create = None
    if "newPvc" in vol:
        pvc = copy.deepcopy(vol["newPvc"])
        name = deep_get(pvc, "metadata", "name", default="") or ""
        name = name.replace("{notebook-name}", nb["metadata"]["name"])
        pvc.setdefault("metadata", {})["name"] = name
        pvc["metadata"]["namespace"] = ns
        pvc.setdefault("apiVersion", "v1")
        pvc.setdefault("kind", "PersistentVolumeClaim")
        pvc_to_create = pvc
        claim = name
    elif "existingSource" in vol:
        claim = deep_get(vol, "existingSource", "persistentVolumeClaim",
                         "claimName")
        if not claim:
            raise HTTPError(400, "existingSource requires a PVC claimName")
    else:
        raise HTTPError(400,
                        "volume must specify newPvc or existingSource")
    vol_name = claim
    spec = nb["spec"]["template"]["spec"]
    spec.setdefault("volumes", []).append(
        {"name": vol_name, "persistentVolumeClaim": {"claimName": claim}})
    _container(nb).setdefault("volumeMounts", []).append(
        {"mountPath": mount, "name": vol_name})
    return pvc_to_create


# --- the app ----------------------------------------------------------

def _dry_run_poddefault_merge(api, namespace: str, nb: dict) -> None:
    """Run the worker-pod shape the controller will render through the
    PodDefault merge engine WITHOUT persisting anything; an atomic
    conflict rejection becomes a spawn-time 400 (dry-run admission,
    the reference's post.py:51-57 dry-run create)."""
    from kubeflow_rm_tpu_torch.controlplane.apiserver import AdmissionDenied
    from kubeflow_rm_tpu_torch.controlplane.webhook.poddefault import (
        PodDefaultWebhook,
    )

    pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "name": f"{nb['metadata']['name']}-0",
            "namespace": namespace,
            "labels": dict(nb["metadata"].get("labels") or {}),
            "annotations": dict(
                deep_get(nb, "spec", "template", "metadata",
                         "annotations", default={}) or {}),
        },
        "spec": fast_deepcopy(
            deep_get(nb, "spec", "template", "spec", default={})),
    }
    try:
        PodDefaultWebhook(api)("CREATE", pod, None)
    except AdmissionDenied as e:
        raise HTTPError(400, str(e)) from e


def create_app(api: APIServer, *, config_path: str | None = None,
               disable_auth: bool = False, prefix: str = "",
               **app_kwargs) -> WebApp:
    app = WebApp("jupyter", api, prefix=prefix, disable_auth=disable_auth,
                 **app_kwargs)
    defaults = load_spawner_config(config_path)

    # readiness hub is built lazily: the in-memory backend spawns a
    # dispatch thread per watcher, and most app instances (tests,
    # short-lived tools) never take a readiness long-poll
    _hub_lock = make_lock("jupyter.hub_registry")
    _hub_box: list[ReadinessHub] = []

    def _hub() -> ReadinessHub:
        with _hub_lock:
            if not _hub_box:
                _hub_box.append(ReadinessHub(api))
            return _hub_box[0]

    @app.route("/api/config")
    def get_config(req):
        return {"config": defaults}

    @app.route("/api/namespaces")
    def get_namespaces(req):
        app.ensure_authorized(req, "list", "namespaces")
        return {"namespaces": [n["metadata"]["name"]
                               for n in api.list("Namespace")]}

    @app.route("/api/tpus")
    def get_tpus(req):
        """Slice types that are both configured and present in the
        node inventory (generalizes /api/gpus, routes/get.py:101-126):
        each type whose host shape (accelerator, cards a host) some
        node has."""
        offered = [o for o in defaults.get("tpu", {}).get("options", [])
                   if o != "none"]
        live = set(gpu_api.slice_types_on(api.list("Node")))
        available = [o for o in offered if o in live]
        return {"tpus": [
            {"acceleratorType": a,
             "chips": gpu_api.lookup(a).cards,
             "hosts": gpu_api.lookup(a).hosts,
             "topology": gpu_api.lookup(a).topology}
            for a in available]}

    @app.route("/api/namespaces/<namespace>/notebooks")
    def list_notebooks(req, namespace):
        app.ensure_authorized(req, "list", "notebooks", namespace)
        out = []
        for nb in api.list(nb_api.KIND, namespace):
            st = status_mod.process_status(nb, api.events_for(nb))
            out.append(_summarize(nb, st))
        return {"notebooks": out}

    @app.route("/api/namespaces/<namespace>/notebooks/<name>")
    def get_notebook(req, namespace, name):
        app.ensure_authorized(req, "get", "notebooks", namespace)
        nb = api.get(nb_api.KIND, name, namespace)
        nb["processed_status"] = status_mod.process_status(
            nb, api.events_for(nb)).to_dict()
        return {"notebook": nb}

    @app.route("/api/namespaces/<namespace>/notebooks/<name>/readiness")
    def get_notebook_readiness(req, namespace, name):
        """Long-poll readiness: block until the notebook's
        resourceVersion moves past ``knownVersion`` (or
        ``timeoutSeconds`` elapses), woken by the watch stream through
        the ReadinessHub — the push path that replaces the SPA's and
        conformance client's fixed-interval status polling. Clients
        loop: pass the last observed resourceVersion back in and each
        request returns at watch latency, not poll-tick latency."""
        app.ensure_authorized(req, "get", "notebooks", namespace)
        raw = req.args.get("timeoutSeconds", "30")
        try:
            timeout = float(raw)
        except ValueError:
            raise HTTPError(400, f"timeoutSeconds must be a number, "
                                 f"got {raw!r}")
        timeout = max(0.0, min(timeout, 120.0))
        known = req.args.get("knownVersion", "")

        # an incoming readiness poll IS demand: transparently resume a
        # suspended notebook before blocking (wake=false opts out for
        # passive dashboards that must not un-park what they observe)
        if req.args.get("wake", "true") != "false":
            cur = api.try_get(nb_api.KIND, name, namespace)
            if cur is not None and \
                    nb_api.SUSPEND_ANNOTATION in annotations_of(cur):
                suspend_mod.request_resume(api, cur,
                                           source="readiness request")

        def fetch():
            return api.try_get(nb_api.KIND, name, namespace)

        def moved(nb):
            if nb is None:
                # a deletion is a change worth reporting — but with no
                # baseline ("" = first subscribe) keep waiting for the
                # notebook to appear
                return known != ""
            rv = deep_get(nb, "metadata", "resourceVersion", default="")
            return known == "" or str(rv) != known

        nb, changed = _hub().wait(namespace, name, timeout, fetch, moved)
        if nb is None:
            raise HTTPError(404, f"notebook {name} in namespace "
                                 f"{namespace} not found")
        nb["processed_status"] = status_mod.process_status(
            nb, api.events_for(nb)).to_dict()
        desired = deep_get(nb, "status", "desiredReplicas",
                           default=nb_api.total_hosts(nb))
        ready_n = deep_get(nb, "status", "readyReplicas", default=0)
        return {"notebook": nb, "changed": changed,
                "ready": bool(desired) and ready_n >= desired}

    @app.route("/api/namespaces/<namespace>/notebooks/<name>/events")
    def get_notebook_events(req, namespace, name):
        app.ensure_authorized(req, "get", "notebooks", namespace)
        nb = api.get(nb_api.KIND, name, namespace)
        return {"events": api.events_for(nb)}

    @app.route("/api/namespaces/<namespace>/notebooks/<name>/pods")
    def get_notebook_pods(req, namespace, name):
        """Per-host view of the slice: one pod per ordinal, with phase
        — the ref lists a single server pod
        (jupyter/backend/apps/common/routes/get.py); a card slice has
        `hosts` of them."""
        app.ensure_authorized(req, "get", "notebooks", namespace)
        nb = api.get(nb_api.KIND, name, namespace)
        pods = sorted(
            (p for p in api.list("Pod", namespace)
             if (p["metadata"].get("labels") or {}).get(
                 nb_api.NOTEBOOK_NAME_LABEL) == name),
            key=lambda p: p["metadata"]["name"])
        return {"pods": [
            {"name": p["metadata"]["name"],
             "phase": deep_get(p, "status", "phase"),
             "nodeName": deep_get(p, "spec", "nodeName")}
            for p in pods]}

    @app.route(
        "/api/namespaces/<namespace>/notebooks/<name>/pods/<ordinal>/logs")
    def get_notebook_pod_logs(req, namespace, name, ordinal):
        """Container logs for one slice host (pod ordinal) — the
        debugging surface for a hung multi-host rendezvous. Ref:
        jupyter/backend/apps/common/routes/get.py `get_pod_logs`."""
        app.ensure_authorized(req, "get", "notebooks", namespace)
        api.get(nb_api.KIND, name, namespace)  # 404 on unknown notebook
        try:
            ordinal = int(ordinal)
        except ValueError:
            raise HTTPError(400, f"pod ordinal must be an integer, "
                                 f"got {ordinal!r}")
        raw = req.args.get("tailLines")
        try:
            tail = int(raw) if raw is not None else None
        except ValueError:
            raise HTTPError(400,
                            f"tailLines must be an integer, got {raw!r}")
        pod_name = f"{name}-{ordinal}"
        # The pod must belong to THIS notebook: a name-prefix match alone
        # would let notebook 'a' read pods of notebook 'a-b'.
        pod = api.try_get("Pod", pod_name, namespace)
        if pod is None or (pod["metadata"].get("labels") or {}).get(
                nb_api.NOTEBOOK_NAME_LABEL) != name:
            raise HTTPError(404,
                            f"pod {pod_name} of notebook {name} not found")
        # kube semantics delegated to pod_logs: 0 -> nothing, <0 -> 4xx
        text = api.pod_logs(namespace, pod_name, tail_lines=tail)
        return {"logs": text.splitlines()}

    @app.route("/api/namespaces/<namespace>/notebooks", methods=("POST",))
    def post_notebook(req, namespace):
        app.ensure_authorized(req, "create", "notebooks", namespace)
        body = json_body(req)
        if "name" not in body:
            raise HTTPError(400, "'name' is a required body field")
        user = app.username(req) or "anonymous@kubeflow.org"

        nb = nb_api.make_notebook(body["name"], namespace)
        nb["metadata"].setdefault("labels", {})
        nb["metadata"].setdefault("annotations", {})
        nb["spec"]["template"]["spec"]["serviceAccountName"] = \
            "default-editor"
        set_annotation(nb, "notebooks.kubeflow.org/creator", user)

        set_image(nb, body, defaults)
        set_server_type(nb, body, defaults)
        set_cpu(nb, body, defaults)
        set_memory(nb, body, defaults)
        set_tpu(nb, body, defaults)
        set_tolerations(nb, body, defaults)
        set_affinity(nb, body, defaults)
        set_configurations(nb, body, defaults)
        set_shm(nb, body, defaults)
        set_environment(nb, body, defaults)
        cls = get_form_value(body, defaults, "priorityClassName",
                             optional=True)
        if cls:
            nb["spec"]["priorityClassName"] = cls

        vols = list(get_form_value(body, defaults, "datavols", "dataVolumes")
                    or [])
        workspace = get_form_value(body, defaults, "workspace",
                                   "workspaceVolume", optional=True)
        if workspace:
            vols.insert(0, workspace)

        # fold volume mounts into the template FIRST (no side
        # effects), dry-run the PodDefault merge the pods will go
        # through (the reference dry-run-creates before the real
        # create — post.py:51-57), and only then create PVCs: a
        # conflicting configuration or mountPath gets a 400 AT SPAWN,
        # leaving nothing behind
        pvcs = [pvc for vol in vols
                for pvc in [_mount_volume(namespace, nb, vol)] if pvc]
        _dry_run_poddefault_merge(api, namespace, nb)
        for pvc in pvcs:
            api.create(pvc)

        api.create(nb)
        return {"message": "Notebook created successfully."}

    @app.route("/api/namespaces/<namespace>/notebooks/<name>",
               methods=("PATCH",))
    def patch_notebook(req, namespace, name):
        app.ensure_authorized(req, "update", "notebooks", namespace)
        body = json_body(req)
        nb = api.get(nb_api.KIND, name, namespace)
        if "stopped" in body:
            ann = annotations_of(nb)
            if body["stopped"]:
                set_annotation(nb, nb_api.STOP_ANNOTATION,
                               api.clock().isoformat())
            else:
                ann.pop(nb_api.STOP_ANNOTATION, None)
            api.update(nb)
        if "suspended" in body:
            # the API arm of the lifecycle: true parks the slice
            # through the same checkpoint-then-drain path the idle
            # suspender uses; false is an explicit resume request
            if body["suspended"]:
                suspend_mod.initiate_suspend(api, nb, reason="api")
            else:
                suspend_mod.request_resume(api, nb, source="api")
        return {"message": "Notebook updated successfully."}

    @app.route("/api/namespaces/<namespace>/notebooks/<name>",
               methods=("DELETE",))
    def delete_notebook(req, namespace, name):
        app.ensure_authorized(req, "delete", "notebooks", namespace)
        api.delete(nb_api.KIND, name, namespace)
        return {"message": "Notebook deleted successfully."}

    @app.route("/api/namespaces/<namespace>/pvcs")
    def list_pvcs(req, namespace):
        app.ensure_authorized(req, "list", "persistentvolumeclaims",
                              namespace)
        return {"pvcs": api.list("PersistentVolumeClaim", namespace)}

    @app.route("/api/namespaces/<namespace>/poddefaults")
    def list_poddefaults(req, namespace):
        app.ensure_authorized(req, "list", "poddefaults", namespace)
        pds = api.list("PodDefault", namespace)
        return {"poddefaults": [
            {"label": deep_get(p, "spec", "selector", "matchLabels",
                               default={}),
             "desc": deep_get(p, "spec", "desc",
                              default=p["metadata"]["name"]),
             "name": p["metadata"]["name"]}
            for p in pds]}

    return app


def _summarize(nb: dict, st) -> dict:
    topo = nb_api.tpu_spec(nb)
    container = deep_get(nb, "spec", "template", "spec", "containers", 0,
                         default={})
    return {
        "name": nb["metadata"]["name"],
        "namespace": nb["metadata"]["namespace"],
        "image": container.get("image"),
        "serverType": annotations_of(nb).get(nb_api.SERVER_TYPE_ANNOTATION),
        "tpu": ({"acceleratorType": topo.accelerator_type,
                 "chips": topo.cards, "hosts": topo.hosts}
                if topo else None),
        "status": st.to_dict(),
        "age": nb["metadata"].get("creationTimestamp"),
    }
