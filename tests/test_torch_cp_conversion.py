"""Notebook/TPUJob CRD version conversion in the port
(``controlplane/api/conversion.py``, slice 7e-1), held to JAX's: the
cases of ``tests/test_conversion.py`` that need no web server (v1 ↔
v1beta1 ↔ v1alpha1, the ConversionReview protocol) and the TPUJob hub
conversion of ``tests/test_tpujob.py``. Each case converts the same
object in both packages; the port's result must equal JAX's after the
TPU→GPU key map (the slice types: ``v5p-16`` → ``h100-80gb-2x4``; the
keys are JAX's in both). The cases that go through ``webhook_server``,
``restserver`` or ``crds`` are in ``test_torch_cp_deploy.py``.
"""

import importlib
import json

import pytest

from tests.torch_cp_parity import key_map

PKGS = ("port", "jax")
SLICE = {"port": "h100-80gb-2x4", "jax": "v5p-16"}


def _m(pkg, name):
    root = "kubeflow_rm_tpu" if pkg == "jax" else "kubeflow_rm_tpu_torch"
    return importlib.import_module(f"{root}.controlplane.{name}")


def _both(case):
    """``case(pkg)`` in each package; the port's result must equal JAX's
    after the key map. Returns the port's."""
    port, jax = case("port"), case("jax")
    assert port == key_map(jax)
    return port


def _v1_nb(pkg, **kw):
    return _m(pkg, "api.notebook").make_notebook(
        "conv", "ns", accelerator_type=SLICE[pkg], num_slices=2, **kw)


def test_keys_and_versions_equal_jax():
    port, jax = _m("port", "api.conversion"), _m("jax", "api.conversion")
    for name in ("GROUP", "STORAGE_VERSION", "SERVED_VERSIONS",
                 "TPU_ACCELERATOR_ANNOTATION", "TPU_NUM_SLICES_ANNOTATION",
                 "LEGACY_TPU_ACCELERATOR_ANNOTATION",
                 "LEGACY_TPU_NUM_SLICES_ANNOTATION",
                 "TPU_JOB_ROLES_ANNOTATION"):
        assert getattr(port, name) == getattr(jax, name), name
    assert sorted(port.CONVERTERS) == sorted(jax.CONVERTERS)
    # the spoke annotation is the label the port's controller stamps
    assert port.TPU_ACCELERATOR_ANNOTATION == \
        _m("port", "api.notebook").TPU_ACCELERATOR_LABEL


def test_v1_to_v1beta1_demotes_tpu_to_annotations():
    def case(pkg):
        c = _m(pkg, "api.conversion")
        nb = _v1_nb(pkg)
        beta = c.convert_notebook(nb, "v1beta1")
        assert beta["spec"]["template"] == nb["spec"]["template"]
        assert nb["spec"]["tpu"]["acceleratorType"] == SLICE[pkg]
        return beta

    beta = _both(case)
    from kubeflow_rm_tpu_torch.controlplane.api import conversion as c
    assert beta["apiVersion"] == "kubeflow.org/v1beta1"
    assert "tpu" not in beta["spec"]
    ann = beta["metadata"]["annotations"]
    assert ann[c.TPU_ACCELERATOR_ANNOTATION] == "h100-80gb-2x4"
    assert ann[c.TPU_NUM_SLICES_ANNOTATION] == "2"


def test_round_trip_is_lossless_both_ways():
    def case(pkg):
        c = _m(pkg, "api.conversion")
        nb = _v1_nb(pkg, annotations={"user-note": "keep me"})
        beta = c.convert_notebook(nb, "v1beta1")
        back = c.convert_notebook(beta, "v1")
        assert back == nb
        beta2 = c.convert_notebook(back, "v1beta1")
        assert beta2 == beta
        return [beta, back]

    beta, _ = _both(case)
    assert beta["metadata"]["annotations"]["user-note"] == "keep me"


def test_cpu_notebook_converts_cleanly():
    def case(pkg):
        c = _m(pkg, "api.conversion")
        nb = _m(pkg, "api.notebook").make_notebook("cpu", "ns")
        beta = c.convert_notebook(nb, "v1beta1")
        assert c.convert_notebook(beta, "v1") == nb
        return beta

    assert "annotations" not in _both(case)["metadata"]


@pytest.mark.parametrize("pkg", PKGS)
def test_identity_conversion_and_unknown_versions(pkg):
    c = _m(pkg, "api.conversion")
    nb = _v1_nb(pkg)
    same = c.convert_notebook(nb, "v1")
    assert same == nb and same is not nb
    with pytest.raises(ValueError):
        c.convert_notebook(nb, "v2")
    with pytest.raises(ValueError):
        c.convert_notebook(dict(nb, apiVersion="kubeflow.org/v0"), "v1")


def test_spec_tpu_wins_over_stray_annotations():
    def case(pkg):
        c = _m(pkg, "api.conversion")
        beta = c.convert_notebook(_v1_nb(pkg), "v1beta1")
        beta["spec"]["tpu"] = {"acceleratorType": SLICE[pkg]}
        beta["metadata"]["annotations"][c.TPU_ACCELERATOR_ANNOTATION] = \
            {"port": "h100-80gb-4", "jax": "v5p-8"}[pkg]
        return c.convert_notebook(beta, "v1")

    v1 = _both(case)
    from kubeflow_rm_tpu_torch.controlplane.api import conversion as c
    assert v1["spec"]["tpu"]["acceleratorType"] == "h100-80gb-2x4"
    assert c.TPU_ACCELERATOR_ANNOTATION not in (
        v1["metadata"].get("annotations") or {})


@pytest.mark.parametrize("pkg", PKGS)
def test_bad_slices_annotation_is_an_error(pkg):
    c = _m(pkg, "api.conversion")
    beta = c.convert_notebook(_v1_nb(pkg), "v1beta1")
    beta["metadata"]["annotations"][c.TPU_NUM_SLICES_ANNOTATION] = "lots"
    with pytest.raises(ValueError, match="not an integer"):
        c.convert_notebook(beta, "v1")


def test_conversion_review_protocol():
    def case(pkg):
        c = _m(pkg, "api.conversion")
        review = {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "ConversionReview",
            "request": {
                "uid": "u-1", "desiredAPIVersion": "kubeflow.org/v1beta1",
                "objects": [_v1_nb(pkg), _m(pkg, "api.notebook")
                            .make_notebook("cpu", "ns")]}}
        ok = c.convert_review(review)
        bad = c.convert_review(dict(review, request=dict(
            review["request"], desiredAPIVersion="kubeflow.org/v9")))
        return [ok, bad]

    ok, bad = _both(case)
    resp = ok["response"]
    assert resp["uid"] == "u-1" and resp["result"]["status"] == "Success"
    assert [o["apiVersion"] for o in resp["convertedObjects"]] == [
        "kubeflow.org/v1beta1"] * 2
    assert bad["response"]["result"]["status"] == "Failed"


# ---- v1alpha1: the pre-prefix annotation shape -----------------------

def test_v1_to_v1alpha1_uses_legacy_annotation_keys():
    def case(pkg):
        return _m(pkg, "api.conversion").convert_notebook(_v1_nb(pkg),
                                                          "v1alpha1")

    alpha = _both(case)
    from kubeflow_rm_tpu_torch.controlplane.api import conversion as c
    assert alpha["apiVersion"] == "kubeflow.org/v1alpha1"
    assert "tpu" not in alpha["spec"]
    ann = alpha["metadata"]["annotations"]
    assert ann[c.LEGACY_TPU_ACCELERATOR_ANNOTATION] == "h100-80gb-2x4"
    assert ann[c.LEGACY_TPU_NUM_SLICES_ANNOTATION] == "2"
    assert c.TPU_ACCELERATOR_ANNOTATION not in ann


def test_v1alpha1_round_trips_through_hub():
    def case(pkg):
        c = _m(pkg, "api.conversion")
        nb = _v1_nb(pkg, annotations={"user-note": "keep me"})
        alpha = c.convert_notebook(nb, "v1alpha1")
        assert c.convert_notebook(alpha, "v1") == nb
        beta = c.convert_notebook(alpha, "v1beta1")
        assert c.convert_notebook(beta, "v1alpha1") == alpha
        return beta

    ann = _both(case)["metadata"]["annotations"]
    from kubeflow_rm_tpu_torch.controlplane.api import conversion as c
    assert ann[c.TPU_ACCELERATOR_ANNOTATION] == "h100-80gb-2x4"
    assert ann["user-note"] == "keep me"
    assert c.LEGACY_TPU_ACCELERATOR_ANNOTATION not in ann


def test_conversion_review_serves_v1alpha1():
    def case(pkg):
        return _m(pkg, "api.conversion").convert_review({
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "ConversionReview",
            "request": {"uid": "u-alpha",
                        "desiredAPIVersion": "kubeflow.org/v1alpha1",
                        "objects": [_v1_nb(pkg)]}})

    obj = _both(case)["response"]["convertedObjects"][0]
    assert obj["apiVersion"] == "kubeflow.org/v1alpha1"
    assert "tpu" not in obj["spec"]


# ---- TPUJob hub conversion (test_tpujob.py) --------------------------

def _podracer(pkg):
    return _m(pkg, "api.tpujob").make_tpujob("pr", "rl", roles=[
        {"name": "learner", "replicas": 1,
         "tpu": {"acceleratorType": SLICE[pkg]}},
        {"name": "actors", "replicas": 4, "cpu": "2"}])


@pytest.mark.parametrize("spoke", ["v1beta1", "v1alpha1"])
def test_tpujob_conversion_round_trips(spoke):
    def case(pkg):
        c = _m(pkg, "api.conversion")
        job = _podracer(pkg)
        down = c.convert_tpujob(job, spoke)
        back = c.convert_tpujob(down, "v1")
        assert back["spec"]["roles"] == job["spec"]["roles"]
        return [down, back]

    down, back = _both(case)
    from kubeflow_rm_tpu_torch.controlplane.api import conversion as c
    assert down["apiVersion"].endswith(spoke)
    assert "roles" not in (down.get("spec") or {})
    roles = json.loads(down["metadata"]["annotations"][
        c.TPU_JOB_ROLES_ANNOTATION])
    assert [r["name"] for r in roles] == ["learner", "actors"]
    assert roles[0]["tpu"]["acceleratorType"] == "h100-80gb-2x4"
    assert c.TPU_JOB_ROLES_ANNOTATION not in (
        back["metadata"].get("annotations") or {})


def test_tpujob_convert_review_wire_protocol():
    def case(pkg):
        return _m(pkg, "api.conversion").convert_review({
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "ConversionReview",
            "request": {"uid": "u-1",
                        "desiredAPIVersion": "kubeflow.org/v1beta1",
                        "objects": [_podracer(pkg)]}})

    resp = _both(case)["response"]
    from kubeflow_rm_tpu_torch.controlplane.api import conversion as c
    assert resp["uid"] == "u-1" and resp["result"]["status"] == "Success"
    got = resp["convertedObjects"][0]
    assert got["apiVersion"] == "kubeflow.org/v1beta1"
    assert c.TPU_JOB_ROLES_ANNOTATION in got["metadata"]["annotations"]


@pytest.mark.parametrize("pkg", PKGS)
def test_tpujob_conversion_rejects_bad_annotation_json(pkg):
    c = _m(pkg, "api.conversion")
    bad = _m(pkg, "api.tpujob").make_tpujob(
        "j", "rl", roles=[{"name": "a", "replicas": 1}])
    bad = c.convert_tpujob(bad, "v1beta1")
    bad["metadata"]["annotations"][c.TPU_JOB_ROLES_ANNOTATION] = "{not json"
    with pytest.raises(ValueError, match="not valid JSON"):
        c.convert_tpujob(bad, "v1")
