"""PodDefault mutating webhook: the pod merge engine.

Re-implements the reference's standalone admission webhook
(``components/admission-webhook/main.go``): select PodDefaults in the
pod's namespace by label selector (``filterPodDefaults`` ``:72-99``),
prove the merge is conflict-free BEFORE touching the pod
(``safeToApplyPodDefaultsOnPod`` ``:101-152`` — a conflicted merge is
rejected atomically, never half-applied), then merge env, envFrom,
volumes, volumeMounts, tolerations, sidecars, initContainers,
imagePullSecrets, serviceAccountName, command/args, labels and
annotations (``applyPodDefaultsOnPod`` ``:480-560``).

Registered on the in-memory apiserver's admission chain for Pods —
the same interposition point the real webhook has via
MutatingWebhookConfiguration.

(The port's copy of ``kubeflow_rm_tpu/controlplane/webhook/poddefault.py``,
verbatim. ``make_control_plane`` registers it before
:mod:`.gpu_inject`, as JAX registers it before its TPU injector: the
injection must see the final container set.)
"""

from __future__ import annotations

import copy

from kubeflow_rm_tpu_torch.controlplane.api import poddefault as pd_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    fast_deepcopy,
    annotations_of,
    deep_get,
    labels_of,
    matches_selector,
    name_of,
    namespace_of,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import AdmissionDenied, APIServer


class PodDefaultWebhook:
    def __init__(self, api: APIServer):
        self.api = api

    def register(self) -> None:
        self.api.register_admission("Pod", self)

    def __call__(self, op: str, pod: dict, old: dict | None) -> dict | None:
        if op != "CREATE":
            return None
        if annotations_of(pod).get(pd_api.EXCLUDE_ANNOTATION) == "true":
            return None
        matching = self._filter(pod)
        if not matching:
            return None
        self._check_conflicts(pod, matching)
        pod = fast_deepcopy(pod)
        for pd in matching:
            self._apply(pod, pd)
        return pod

    # ---- selection (ref :72-99) --------------------------------------
    def _filter(self, pod: dict) -> list[dict]:
        ns = namespace_of(pod)
        out = []
        for pd in self.api.list(pd_api.KIND, ns):
            selector = deep_get(pd, "spec", "selector", default={})
            if matches_selector(labels_of(pod), selector):
                out.append(pd)
        out.sort(key=name_of)
        return out

    # ---- conflict detection (ref :101-152) ---------------------------
    def _check_conflicts(self, pod: dict, pds: list[dict]) -> None:
        env_seen: dict[str, tuple[str, object]] = {}
        for c in deep_get(pod, "spec", "containers", default=[]) or []:
            for e in c.get("env") or []:
                env_seen[e["name"]] = ("pod", _env_value(e))
        mount_seen: dict[str, tuple[str, str]] = {}
        for c in deep_get(pod, "spec", "containers", default=[]) or []:
            for m in c.get("volumeMounts") or []:
                mount_seen[m["mountPath"]] = ("pod", m.get("name", ""))
        vol_seen: dict[str, tuple[str, dict]] = {}
        for v in deep_get(pod, "spec", "volumes", default=[]) or []:
            vol_seen[v["name"]] = ("pod", v)

        for pd in pds:
            src = name_of(pd)
            for e in deep_get(pd, "spec", "env", default=[]) or []:
                prev = env_seen.get(e["name"])
                if prev is not None and prev[1] != _env_value(e):
                    raise AdmissionDenied(
                        f"PodDefault {src}: env {e['name']!r} conflicts "
                        f"with {prev[0]}")
                env_seen[e["name"]] = (src, _env_value(e))
            for m in deep_get(pd, "spec", "volumeMounts", default=[]) or []:
                prev = mount_seen.get(m["mountPath"])
                if prev is not None and prev[1] != m.get("name", ""):
                    raise AdmissionDenied(
                        f"PodDefault {src}: mountPath {m['mountPath']!r} "
                        f"conflicts with {prev[0]}")
                mount_seen[m["mountPath"]] = (src, m.get("name", ""))
            for v in deep_get(pd, "spec", "volumes", default=[]) or []:
                prev = vol_seen.get(v["name"])
                if prev is not None and prev[1] != v:
                    raise AdmissionDenied(
                        f"PodDefault {src}: volume {v['name']!r} conflicts "
                        f"with {prev[0]}")
                vol_seen[v["name"]] = (src, v)

    # ---- merge (ref :170-560) ----------------------------------------
    def _apply(self, pod: dict, pd: dict) -> None:
        spec = pod.setdefault("spec", {})
        pspec = pd.get("spec", {})

        for v in pspec.get("volumes") or []:
            vols = spec.setdefault("volumes", [])
            if not any(x["name"] == v["name"] for x in vols):
                vols.append(copy.deepcopy(v))

        for c in spec.get("containers") or []:
            for e in pspec.get("env") or []:
                env = c.setdefault("env", [])
                if not any(x["name"] == e["name"] for x in env):
                    env.append(copy.deepcopy(e))
            for ef in pspec.get("envFrom") or []:
                envfrom = c.setdefault("envFrom", [])
                if ef not in envfrom:
                    envfrom.append(copy.deepcopy(ef))
            for m in pspec.get("volumeMounts") or []:
                mounts = c.setdefault("volumeMounts", [])
                if not any(x["mountPath"] == m["mountPath"]
                           for x in mounts):
                    mounts.append(copy.deepcopy(m))
            if pspec.get("command") and not c.get("command"):
                c["command"] = list(pspec["command"])
            if pspec.get("args") and not c.get("args"):
                c["args"] = list(pspec["args"])

        for t in pspec.get("tolerations") or []:
            tols = spec.setdefault("tolerations", [])
            if t not in tols:
                tols.append(copy.deepcopy(t))
        for s in pspec.get("imagePullSecrets") or []:
            secrets = spec.setdefault("imagePullSecrets", [])
            if s not in secrets:
                secrets.append(copy.deepcopy(s))
        for sc in pspec.get("sidecars") or []:
            containers = spec.setdefault("containers", [])
            if not any(c["name"] == sc["name"] for c in containers):
                containers.append(copy.deepcopy(sc))
        for ic in pspec.get("initContainers") or []:
            inits = spec.setdefault("initContainers", [])
            if not any(c["name"] == ic["name"] for c in inits):
                inits.append(copy.deepcopy(ic))

        if pspec.get("serviceAccountName") and \
                spec.get("serviceAccountName") in (None, "", "default"):
            spec["serviceAccountName"] = pspec["serviceAccountName"]
        if "automountServiceAccountToken" in pspec:
            spec.setdefault("automountServiceAccountToken",
                            pspec["automountServiceAccountToken"])

        meta = pod["metadata"]
        for k, v in (pspec.get("labels") or {}).items():
            meta.setdefault("labels", {}).setdefault(k, v)
        for k, v in (pspec.get("annotations") or {}).items():
            meta.setdefault("annotations", {}).setdefault(k, v)
        meta.setdefault("annotations", {})[
            pd_api.APPLIED_ANNOTATION_PREFIX + name_of(pd)
        ] = pd["metadata"].get("resourceVersion", "0")


def _env_value(e: dict):
    return e.get("value") if "value" in e else e.get("valueFrom")
