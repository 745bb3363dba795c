"""Object-graph parity of the notebook platform's admission webhooks and
the auth companion: the same script on JAX's ``make_control_plane()``
and on the port's (its informer cache on, JAX's default), then every
object of every kind on both servers — Events included — compared after
the key map (``torch_cp_parity.key_map``). A denial's message is
compared word for word.

- the PodDefault webhook (``webhook/poddefault.py``): env, envFrom,
  volumes, mounts, sidecars, tolerations, labels and annotations merged
  into a selected pod; a conflict denied with JAX's message; the merge
  before the card injection;
- the notebook webhook (``webhook/notebook.py``): the reconciliation
  lock stamped and released, a short image resolved through the
  ``notebook-images`` ConfigMap (at admission and, when the ConfigMap
  comes later, by the lock release), an unresolvable image holding the
  lock, the no-restart guard on a running notebook, and the opt-in;
- the auth companion (``controllers/authcompanion.py``): the plain route
  and policies, the OAuth machinery and sidecar, the trusted-CA bundle,
  and a 2 × 4 slice whose NetworkPolicy is the one mapped difference.

(Counterparts of ``tests/test_poddefault_webhook.py`` and
``tests/test_authcompanion.py``.)
"""

import pytest

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, jax_switch_defaults, parity, run_full,
)

INJECT_OAUTH = "notebooks.kubeflow.org/inject-oauth"


def _pod(name="p", labels=None, env=None, volumes=None, mounts=None):
    c = {"name": "main", "image": "img"}
    if env:
        c["env"] = env
    if mounts:
        c["volumeMounts"] = mounts
    spec = {"containers": [c]}
    if volumes:
        spec["volumes"] = volumes
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": NS,
                         "labels": labels or {}},
            "spec": spec}


def _denied(S, fn):
    """The admission denial's message, or None when ``fn`` passes."""
    try:
        fn()
    except S.m("apiserver").AdmissionDenied as e:
        return str(e)
    return None


# ---- PodDefaults --------------------------------------------------------

def test_poddefaults_merge_into_selected_pods(parity):
    def script(S):
        pd = S.m("api.poddefault")
        S.api.ensure_namespace(NS)
        S.api.create(pd.make_poddefault(
            "gcs-access", NS, selector={"matchLabels": {"add": "true"}},
            env=[{"name": "GOOGLE_CLOUD_PROJECT", "value": "proj"}],
            envFrom=[{"secretRef": {"name": "tokens"}}],
            volumes=[{"name": "cache", "emptyDir": {}}],
            volumeMounts=[{"name": "cache", "mountPath": "/cache"}],
            sidecars=[{"name": "proxy", "image": "proxy:1"}],
            tolerations=[{"key": "gpu", "operator": "Exists"}],
            labels={"merged": "yes"},
            annotations={"note": "from-pd"},
            serviceAccountName="editor", command=["run"]))
        S.api.create(pd.make_poddefault(
            "second", NS, selector={"matchLabels": {"add": "true"}},
            env=[{"name": "GOOGLE_CLOUD_PROJECT", "value": "proj"},
                 {"name": "EXTRA", "value": "1"}]))
        made = [S.api.create(_pod("sel", labels={"add": "true"},
                                  env=[{"name": "OWN", "value": "x"}])),
                S.api.create(_pod("other")),
                S.api.create(_pod("also", labels={"add": "true"}))]
        S.run()
        return made

    made, dump = run_full(parity, script)
    sel = made[0]
    c0 = sel["spec"]["containers"][0]
    assert [e["name"] for e in c0["env"]] == [
        "OWN", "GOOGLE_CLOUD_PROJECT", "EXTRA"]
    assert c0["command"] == ["run"]
    assert sel["spec"]["serviceAccountName"] == "editor"
    assert [c["name"] for c in sel["spec"]["containers"]] == [
        "main", "proxy"]
    assert sel["metadata"]["labels"]["merged"] == "yes"
    assert "env" not in made[1]["spec"]["containers"][0]


def test_poddefault_exclude_pod_env_and_pod_defaults_kept(parity):
    """The exclude annotation skips the merge; a pod's own variable of
    the same value is not duplicated, of another value is a conflict;
    a pod's own service account and command are kept."""
    def script(S):
        pd = S.m("api.poddefault")
        S.api.ensure_namespace(NS)
        S.api.create(pd.make_poddefault(
            "a", NS, selector={"matchLabels": {"m": "1"}},
            env=[{"name": "A", "value": "pd"}],
            serviceAccountName="editor", command=["run.sh"]))
        ex = _pod("ex", labels={"m": "1"})
        ex["metadata"]["annotations"] = {pd.EXCLUDE_ANNOTATION: "true"}
        own = _pod("own", labels={"m": "1"},
                   env=[{"name": "A", "value": "pd"}])
        own["spec"]["serviceAccountName"] = "custom"
        own["spec"]["containers"][0]["command"] = ["mine.sh"]
        return [S.api.create(ex), S.api.create(own),
                _denied(S, lambda: S.api.create(_pod(
                    "clash", labels={"m": "1"},
                    env=[{"name": "A", "value": "mine"}])))]

    (ex, own, msg), _ = run_full(parity, script)
    assert "env" not in ex["spec"]["containers"][0]
    assert own["spec"]["containers"][0]["env"] == [
        {"name": "A", "value": "pd"}]
    assert own["spec"]["serviceAccountName"] == "custom"
    assert own["spec"]["containers"][0]["command"] == ["mine.sh"]
    assert msg == "PodDefault a: env 'A' conflicts with pod"


@pytest.mark.parametrize("clash", ["env", "mount", "volume"])
def test_poddefault_conflict_denied_with_jax_message(parity, clash):
    def script(S):
        pd = S.m("api.poddefault")
        S.api.ensure_namespace(NS)
        fields = {
            "env": lambda v: {"env": [{"name": "SHARED", "value": v}]},
            "mount": lambda v: {"volumeMounts": [
                {"name": v, "mountPath": "/data"}]},
            "volume": lambda v: {"volumes": [
                {"name": "data", "configMap": {"name": v}}]},
        }[clash]
        for name in ("a", "b"):
            S.api.create(pd.make_poddefault(
                name, NS, selector={"matchLabels": {"m": "1"}},
                **fields(f"from-{name}")))
        msg = _denied(S, lambda: S.api.create(_pod(labels={"m": "1"})))
        return [msg, S.api.try_get("Pod", "p", NS)]

    (msg, pod), _ = run_full(parity, script)
    assert msg.startswith("PodDefault b: ") and pod is None


def test_poddefault_on_a_notebook_pod_before_card_injection(parity):
    """The PodDefault merge runs before the card injection: the pod of a
    spawned notebook has both the PodDefault's variable and the slice's
    rendezvous env."""
    def script(S):
        pd = S.m("api.poddefault")
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-4")
        S.api.create(pd.make_poddefault(
            "smoke", NS, selector={"matchLabels": {"team": "ml"}},
            env=[{"name": "KFRM_PODDEFAULT", "value": "smoke"}]))
        S.api.create(S.notebook("nb", "h100-80gb-4",
                                labels={"team": "ml"}))
        S.run()
        pod = S.api.get("Pod", "nb-0", NS)
        return {e["name"]: e.get("value")
                for e in pod["spec"]["containers"][0]["env"]}

    env, _ = run_full(parity, script)
    assert env["KFRM_PODDEFAULT"] == "smoke"
    assert env["TPU_WORKER_ID"] == "0"


def test_poddefault_requires_selector(parity):
    def script(S):
        S.api.ensure_namespace(NS)
        bad = S.m("api.poddefault").make_poddefault(
            "bad", NS, selector={"matchLabels": {}})
        del bad["spec"]["selector"]
        try:
            S.api.create(bad)
        except S.m("apiserver").Invalid as e:
            return str(e)
        return None

    msg, _ = run_full(parity, script)
    assert "selector" in msg


# ---- the notebook webhook ----------------------------------------------

def _images(S, data):
    wh = S.m("webhook.notebook")
    S.api.ensure_namespace(wh.IMAGE_CONFIGMAP_NAMESPACE)
    cm = S.m("api.meta").make_object(
        "v1", "ConfigMap", wh.IMAGE_CONFIGMAP,
        wh.IMAGE_CONFIGMAP_NAMESPACE)
    cm["data"] = dict(data)
    return S.api.create(cm)


def test_lock_stamped_then_released_and_image_resolved(parity):
    full_ref = "registry.example.com/jupyter-torch-cuda:2026.10"

    def script(S):
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-1")
        _images(S, {"jupyter-torch-cuda": full_ref})
        made = S.api.create(S.notebook("nb", "h100-80gb-1",
                                       image="jupyter-torch-cuda"))
        S.run()
        nb = S.api.get(S.nb_api.KIND, "nb", NS)
        pod = S.api.get("Pod", "nb-0", NS)
        return [made["metadata"]["annotations"],
                nb["metadata"].get("annotations"),
                pod["spec"]["containers"][0]["image"]]

    (stamped, after, image), _ = run_full(parity, script)
    assert stamped["kubeflow-resource-stopped"] == "reconciliation-lock"
    assert "kubeflow-resource-stopped" not in (after or {})
    assert image == full_ref


def test_unresolvable_image_holds_the_lock_until_configmap(parity):
    def script(S):
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-1")
        S.api.create(S.notebook("nb", "h100-80gb-1", image="shortname"))
        S.run()
        held = [S.api.get(S.nb_api.KIND, "nb", NS)["metadata"][
                    "annotations"],
                S.api.list("Pod", NS)]
        # the short name appears only now: the lock release resolves it
        _images(S, {"shortname": "registry.example.com/short:1"})
        S.clock.advance(seconds=120)
        S.mgr.enqueue_all()
        S.run()
        nb = S.api.get(S.nb_api.KIND, "nb", NS)
        pod = S.api.get("Pod", "nb-0", NS)
        return held + [nb["metadata"].get("annotations"),
                       pod["spec"]["containers"][0]["image"]]

    (held_ann, held_pods, after, image), dump = run_full(parity, script)
    assert held_ann["kubeflow-resource-stopped"] == "reconciliation-lock"
    assert held_pods == []
    assert "kubeflow-resource-stopped" not in (after or {})
    assert image == "registry.example.com/short:1"
    assert any(e["reason"] == "ReconciliationLockHeld"
               for e in dump["Event"])


def test_no_restart_guard_and_opt_in(parity):
    def script(S):
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-4")
        S.api.create(S.notebook("nb", "h100-80gb-4"))
        S.run()
        nb = S.api.get(S.nb_api.KIND, "nb", NS)
        nb["spec"]["template"]["spec"]["containers"][0]["image"] = "new:1"
        denied = _denied(S, lambda: S.api.update(nb))
        nb = S.api.get(S.nb_api.KIND, "nb", NS)
        nb["spec"]["tpu"]["acceleratorType"] = S.slice("h100-80gb-1")
        denied_slice = _denied(S, lambda: S.api.update(nb))
        nb = S.api.get(S.nb_api.KIND, "nb", NS)
        nb["spec"]["template"]["spec"]["containers"][0]["image"] = "new:1"
        nb["metadata"]["annotations"][S.nb_api.RESTART_ANNOTATION] = "true"
        allowed = _denied(S, lambda: S.api.update(nb))
        S.run()
        return [denied, denied_slice, allowed]

    (denied, denied_slice, allowed), _ = run_full(parity, script)
    assert denied == denied_slice
    assert "is running; spec changes would restart the slice" in denied
    assert allowed is None


# ---- the auth companion ------------------------------------------------

def test_plain_route_policy_and_pipeline_rbac(parity):
    def script(S):
        S.api.ensure_namespace(NS)
        S.api.create(S.nb_api.make_notebook("plain", NS))
        S.run()
        return [S.api.get("Route", "plain", NS)["spec"],
                S.api.get("RoleBinding", "elyra-pipelines-plain",
                          NS)["subjects"]]

    (route, subjects), _ = run_full(parity, script)
    assert route["to"]["name"] == "plain" and "tls" not in route
    assert subjects == [{"kind": "ServiceAccount", "name": "plain",
                         "namespace": NS}]


@pytest.mark.parametrize("acc", ["h100-80gb-1", "h100-80gb-2x4"])
def test_oauth_machinery_and_sidecar(parity, acc):
    def script(S):
        S.api.ensure_namespace(NS)
        hosts = S.topo(S.slice(acc)).hosts
        for i in range(hosts):
            S.node(f"n{i}", acc)
        S.api.create(S.notebook("secure", acc,
                                annotations={INJECT_OAUTH: "true"}))
        S.run()
        stored = S.api.get(S.nb_api.KIND, "secure", NS)
        return [[c["name"] for c in
                 stored["spec"]["template"]["spec"]["containers"]],
                sorted(p["metadata"]["name"]
                       for p in S.api.list("NetworkPolicy", NS)),
                S.api.get("Secret", "secure-oauth-config", NS)["type"]]

    (containers, policies, secret), dump = run_full(parity, script)
    assert containers[-1] == "oauth-proxy"
    multihost = acc == "h100-80gb-2x4"
    assert policies == sorted(["secure-ctrl-np", "secure-oauth-np"]
                              + (["secure-slice-np"] if multihost else []))
    if multihost:
        (peer,) = [p for p in dump["NetworkPolicy"]
                   if p["metadata"]["name"] == "secure-slice-np"]
        assert peer["spec"]["ingress"] == [{"from": [{"podSelector": {
            "matchLabels": {"notebook-name": "secure"}}}]}]
    assert secret == "Opaque"


def test_slice_policy_is_the_one_mapped_difference(parity):
    """Without the key map's slice-policy rule, JAX's 2 × 4 slice differs
    from the port's in exactly the ``ports`` of that policy."""
    from tests import torch_cp_parity as tcp

    def script(S):
        S.api.ensure_namespace(NS)
        for i in range(2):
            S.node(f"n{i}", "h100-80gb-2x4")
        S.api.create(S.notebook("sl", "h100-80gb-2x4"))
        S.run()
        return S.api.get("NetworkPolicy", "sl-slice-np", NS)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcp, "_slice_policy", lambda np_obj: None)
        with pytest.raises(AssertionError):
            run_full(parity, script)
    policy, _ = run_full(parity, script)
    assert policy["spec"]["ingress"] == [{"from": [{"podSelector": {
        "matchLabels": {"notebook-name": "sl"}}}]}]


def test_ca_bundle_assembled_and_mounted(parity):
    def script(S):
        ac = S.m("controllers.authcompanion")
        S.api.ensure_namespace(NS)
        S.api.ensure_namespace(ac.SOURCE_CA_NAMESPACE)
        src = S.m("api.meta").make_object(
            "v1", "ConfigMap", ac.SOURCE_CA_BUNDLE, ac.SOURCE_CA_NAMESPACE)
        src["data"] = {"root.crt": "AAA\n", "intermediate.crt": "BBB\n",
                       "readme.txt": "ignored"}
        S.api.create(src)
        S.api.create(S.nb_api.make_notebook("first", NS))
        S.run()
        S.api.create(S.nb_api.make_notebook("second", NS))
        S.run()
        return S.api.get("ConfigMap", ac.TRUSTED_CA_BUNDLE, NS)["data"]

    data, dump = run_full(parity, script)
    assert data == {"ca-bundle.crt": "BBB\nAAA\n"}
    second = [n for n in dump["Notebook"]
              if n["metadata"]["name"] == "second"][0]
    assert any(v.get("name") == "trusted-ca" for v in
               second["spec"]["template"]["spec"]["volumes"])


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
