"""Multi-version Notebook API + conversion (the port's copy of
``kubeflow_rm_tpu/controlplane/api/conversion.py``).

The port keeps JAX's keys: its Notebook carries the slice under
``spec.tpu`` and its pods under the ``notebooks.kubeflow.org/tpu-*``
labels (:mod:`.notebook`), so the spoke annotations below are those
same strings and only the values differ (``h100-80gb-*`` slice types,
:mod:`.gpu`).

The reference serves ``kubeflow.org/{v1alpha1,v1beta1,v1} Notebook``
with conversion shims between structurally-identical types
(``notebook-controller/api/v1beta1/notebook_types.go:27-34``,
``api/v1/notebook_conversion.go:1-30`` — v1beta1 is the storage "hub",
the others convert through it). This framework serves three versions
with REAL schema deltas, because the TPU block is the field that
actually evolved here:

- ``v1`` (storage/hub): first-class ``spec.tpu {acceleratorType,
  numSlices}`` — what every controller in this repo consumes.
- ``v1beta1`` (served): the reference-era shape — no ``spec.tpu``;
  TPU placement rides the ``notebooks.kubeflow.org/tpu-accelerator-
  type`` / ``tpu-num-slices`` annotations (the same strings the
  controller stamps on pods, so reference-era tooling already knows
  them).
- ``v1alpha1`` (served): the oldest shape — annotation-carried like
  v1beta1 but under the bare ``kubeflow.org/tpu-*`` keys that predate
  the ``notebooks.`` prefix convention.

Conversion is lossless in every direction: spoke→v1 hoists the
annotations into ``spec.tpu``; v1→spoke demotes ``spec.tpu`` into
that spoke's annotation keys. Everything else (the embedded PodSpec,
status, behavior annotations) is version-invariant, exactly as in the
reference.

Served by two paths that must agree (tests assert both):

- the apiextensions ConversionReview endpoint
  (``deploy/webhook_server.py`` ``POST /convert``) — what a real
  cluster calls;
- the REST facade (``deploy/restserver.py``), which converts at the
  collection boundary so a client reading
  ``/apis/kubeflow.org/v1beta1/...`` sees v1beta1 objects over the
  same store.
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api.meta import fast_deepcopy

GROUP = "kubeflow.org"
STORAGE_VERSION = "v1"
SERVED_VERSIONS = ("v1alpha1", "v1beta1", "v1")

#: v1beta1 carries the TPU block as annotations (not labels — these
#: describe the CR itself; the controller separately stamps pod LABELS
#: with the same suffixes for the webhook to read)
TPU_ACCELERATOR_ANNOTATION = "notebooks.kubeflow.org/tpu-accelerator-type"
TPU_NUM_SLICES_ANNOTATION = "notebooks.kubeflow.org/tpu-num-slices"

#: v1alpha1 predates the ``notebooks.`` prefix convention: same
#: annotation-shaped TPU placement under the bare group keys (the
#: oldest tooling's strings). Structurally identical otherwise — the
#: reference's v1alpha1 is likewise a rename-era twin of v1beta1.
LEGACY_TPU_ACCELERATOR_ANNOTATION = "kubeflow.org/tpu-accelerator-type"
LEGACY_TPU_NUM_SLICES_ANNOTATION = "kubeflow.org/tpu-num-slices"


def version_of(obj: dict) -> str:
    api_version = obj.get("apiVersion") or f"{GROUP}/{STORAGE_VERSION}"
    return api_version.rsplit("/", 1)[-1]


def convert_notebook(obj: dict, to_version: str) -> dict:
    """Convert a Notebook between served versions (hub = v1).

    Returns a new object; the input is not mutated. Unknown versions
    raise ValueError (a real conversion webhook answers those with a
    Failure status)."""
    if to_version not in SERVED_VERSIONS:
        raise ValueError(f"unknown Notebook version {to_version!r} "
                         f"(served: {', '.join(SERVED_VERSIONS)})")
    cur = version_of(obj)
    if cur not in SERVED_VERSIONS:
        raise ValueError(f"cannot convert from unknown version {cur!r}")
    out = fast_deepcopy(obj)
    if cur != STORAGE_VERSION:
        out = _annotations_to_hub(out, *_TPU_KEYS[cur])
    if to_version != STORAGE_VERSION:
        out = _hub_to_annotations(out, *_TPU_KEYS[to_version])
    out["apiVersion"] = f"{GROUP}/{to_version}"
    return out


#: spoke version -> (accelerator key, num-slices key): both pre-hub
#: shapes are annotation-carried, they just disagree on key names
_TPU_KEYS = {
    "v1beta1": (TPU_ACCELERATOR_ANNOTATION, TPU_NUM_SLICES_ANNOTATION),
    "v1alpha1": (LEGACY_TPU_ACCELERATOR_ANNOTATION,
                 LEGACY_TPU_NUM_SLICES_ANNOTATION),
}


def _annotations_to_hub(obj: dict, acc_key: str,
                        slices_key: str) -> dict:
    """Hoist the TPU annotations into first-class ``spec.tpu``. An
    object that (illegally) carries both keeps ``spec.tpu`` — the
    structured field is authoritative."""
    ann = (obj.get("metadata") or {}).get("annotations") or {}
    spec = obj.setdefault("spec", {})
    acc = ann.pop(acc_key, None)
    raw_slices = ann.pop(slices_key, None)
    if acc and "tpu" not in spec:
        tpu: dict = {"acceleratorType": acc}
        if raw_slices is not None:
            try:
                n = int(raw_slices)
            except ValueError as e:
                raise ValueError(
                    f"{slices_key}={raw_slices!r} is "
                    "not an integer") from e
            if n != 1:
                tpu["numSlices"] = n
        spec["tpu"] = tpu
    if not ann and "annotations" in (obj.get("metadata") or {}):
        obj["metadata"].pop("annotations", None)
    elif ann:
        obj["metadata"]["annotations"] = ann
    return obj


def _hub_to_annotations(obj: dict, acc_key: str,
                        slices_key: str) -> dict:
    """Demote ``spec.tpu`` into the annotations the pre-hub shapes
    use."""
    spec = obj.get("spec") or {}
    tpu = spec.pop("tpu", None)
    if tpu:
        ann = obj.setdefault("metadata", {}).setdefault(
            "annotations", {})
        ann[acc_key] = tpu["acceleratorType"]
        n = int(tpu.get("numSlices", 1))
        if n != 1:
            ann[slices_key] = str(n)
    return obj


# ---- TPUJob (multi-role gang jobs) -----------------------------------

#: both pre-hub TPUJob spokes carry the role list as ONE JSON
#: annotation under the same key — the kind predates neither prefix
#: convention (it is new), so there is no key rename to model; the
#: spokes exist to exercise the conversion seam the moment the roles
#: schema evolves, and the JSON carrier is lossless for ANY role set
TPU_JOB_ROLES_ANNOTATION = "kubeflow.org/tpu-job-roles"


def convert_tpujob(obj: dict, to_version: str) -> dict:
    """Convert a TPUJob between served versions (hub = v1).

    v1 carries ``spec.roles`` first-class; v1alpha1/v1beta1 demote it
    to a JSON annotation (``TPU_JOB_ROLES_ANNOTATION``). Image and
    priorityClassName are version-invariant."""
    import json

    if to_version not in SERVED_VERSIONS:
        raise ValueError(f"unknown TPUJob version {to_version!r} "
                         f"(served: {', '.join(SERVED_VERSIONS)})")
    cur = version_of(obj)
    if cur not in SERVED_VERSIONS:
        raise ValueError(f"cannot convert from unknown version {cur!r}")
    out = fast_deepcopy(obj)
    if cur != STORAGE_VERSION:
        ann = (out.get("metadata") or {}).get("annotations") or {}
        raw = ann.pop(TPU_JOB_ROLES_ANNOTATION, None)
        spec = out.setdefault("spec", {})
        if raw is not None and "roles" not in spec:
            try:
                spec["roles"] = json.loads(raw)
            except ValueError as e:
                raise ValueError(
                    f"{TPU_JOB_ROLES_ANNOTATION} is not valid JSON"
                ) from e
        if not ann and "annotations" in (out.get("metadata") or {}):
            out["metadata"].pop("annotations", None)
        elif ann:
            out["metadata"]["annotations"] = ann
    if to_version != STORAGE_VERSION:
        spec = out.get("spec") or {}
        job_roles = spec.pop("roles", None)
        if job_roles is not None:
            ann = out.setdefault("metadata", {}).setdefault(
                "annotations", {})
            ann[TPU_JOB_ROLES_ANNOTATION] = json.dumps(
                job_roles, separators=(",", ":"))
    out["apiVersion"] = f"{GROUP}/{to_version}"
    return out


#: kind -> converter; the webhook server and REST facade both dispatch
#: through this table, so adding a multi-version kind is one entry
CONVERTERS = {"Notebook": convert_notebook, "TPUJob": convert_tpujob}


def convert_review(review: dict) -> dict:
    """Answer an apiextensions.k8s.io/v1 ConversionReview request —
    the wire protocol a real apiserver speaks to the conversion
    webhook (strategy: Webhook in the CRD)."""
    req = review.get("request") or {}
    desired = (req.get("desiredAPIVersion") or "").rsplit("/", 1)[-1]
    converted, err = [], None
    for obj in req.get("objects") or []:
        kind = obj.get("kind")
        fn = CONVERTERS.get(kind)
        if fn is None:
            err = f"no conversion registered for kind {kind!r}"
            break
        try:
            converted.append(fn(obj, desired))
        except ValueError as e:
            err = str(e)
            break
    resp: dict = {"uid": req.get("uid")}
    if err is None:
        resp["convertedObjects"] = converted
        resp["result"] = {"status": "Success"}
    else:
        resp["result"] = {"status": "Failed", "message": err}
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "ConversionReview",
        "response": resp,
    }
