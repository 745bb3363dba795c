"""The port's process entry point, ``python -m
kubeflow_rm_tpu_torch.controlplane <cmd>`` (``controlplane/__main__.py``),
held to JAX's: ``main()``'s help, exit codes and unknown-command text;
``crds`` and ``manifests`` output equal to JAX's after the module rename
and the key map (``module_map``/``drop_enums``); every command the
port's manifests start is one ``COMMANDS`` has; then the commands as
real processes over a port ``RestCluster`` on 127.0.0.1 — the gateway
serving the SPA's shell and a jupyter listing, the controller-manager
under ``LEADER_ELECT`` reconciling a Notebook to Ready, the
webhook-server answering an AdmissionReview as the handler does in
process, and each web-app command serving ``/healthz`` — none with torch
loaded, each exiting 0 on SIGTERM within its deadline. Each process runs
under ``chip_smoke.CPProcess`` (start and stop deadlines; a process left
running is killed in ``finally``).
"""

import json
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch  # noqa: F401 - the positive control of the torch check
import yaml

from kubeflow_rm_tpu.controlplane import __main__ as jax_main
from kubeflow_rm_tpu_torch.controlplane import __main__ as port_main
from kubeflow_rm_tpu_torch.controlplane.api.meta import make_object
from kubeflow_rm_tpu_torch.controlplane.api.notebook import make_notebook
from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
    make_gpu_node,
)

import chip_smoke
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, RestCluster, canon, drop_enums,
    jax_switch_defaults, module_map, stop_fanout,
)

ROOT = Path(__file__).resolve().parents[1]
USER = "alice@corp.com"


# ---- main(): help, exit codes, the unknown command ------------------------

@pytest.mark.parametrize("argv", [[], ["-h"], ["--help"], ["nope"],
                                  ["nope", "x"]])
def test_main_answers_as_jax(argv, capsys):
    got = {}
    for name, mod in (("port", port_main), ("jax", jax_main)):
        rc = mod.main(list(argv))
        out, err = capsys.readouterr()
        got[name] = (rc, out, err)
    (prc, pout, perr), (jrc, jout, jerr) = got["port"], got["jax"]
    assert prc == jrc == (2 if not argv or argv[0] == "nope" else 0)
    assert perr == jerr
    # the help: each package's docstring, then the same commands
    assert pout.splitlines()[-1:] == jout.splitlines()[-1:]
    if argv[:1] != ["nope"]:
        assert pout.startswith(port_main.__doc__)
        assert jout.startswith(jax_main.__doc__)
    else:
        assert perr == ("unknown command 'nope'; known: " + ", ".join(
            [*jax_main.COMMANDS, "manifests"]) + "\n")


def test_commands_are_jax():
    assert list(port_main.COMMANDS) == list(jax_main.COMMANDS)
    r = subprocess.run([sys.executable, "-m",
                        "kubeflow_rm_tpu_torch.controlplane", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "commands: " + ", ".join(
        [*jax_main.COMMANDS, "manifests"])


def test_crds_equal_jax(capsys):
    texts = []
    for mod in (port_main, jax_main):
        assert mod.cmd_crds() == 0
        texts.append(capsys.readouterr().out)
    port_text, jax_text = texts
    # the port's documents are JSON, which JAX's YAML reader takes
    for doc in port_text.split("---\n"):
        if doc.strip():
            json.loads(doc)
    got = drop_enums(list(yaml.safe_load_all(port_text)))
    want = drop_enums(module_map(list(yaml.safe_load_all(jax_text))))
    assert len(got) == 6 and canon(got) == canon(want)


def test_manifests_equal_jax(tmp_path):
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    assert port_main.main(["manifests", str(pdir)]) == 0
    assert jax_main.main(["manifests", str(jdir)]) == 0
    port = {p.relative_to(pdir): p.read_text() for p in pdir.rglob("*")
            if p.is_file()}
    jax = {p.relative_to(jdir): p.read_text() for p in jdir.rglob("*")
           if p.is_file()}
    assert sorted(port) == sorted(jax) and port
    for rel in port:
        got = drop_enums(list(yaml.safe_load_all(port[rel])))
        want = drop_enums(module_map(list(yaml.safe_load_all(jax[rel]))))
        assert canon(got) == canon(want), rel


def _commands(obj):
    """Every ``python -m kubeflow_rm_tpu_torch.controlplane <cmd>`` in a
    manifest object."""
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _commands(v)
    elif isinstance(obj, list):
        if obj[:3] == ["python", "-m", "kubeflow_rm_tpu_torch.controlplane"]:
            yield obj[3]
        for v in obj:
            yield from _commands(v)


def test_every_manifest_command_exists(tmp_path):
    port_main.main(["manifests", str(tmp_path)])
    named = set()
    for path in tmp_path.rglob("*.yaml"):
        for doc in yaml.safe_load_all(path.read_text()):
            named |= set(_commands(doc))
    assert {"controller-manager", "webhook-server", "jupyter-web-app",
            "volumes-web-app", "tensorboards-web-app", "kfam",
            "dashboard"} <= named
    assert named <= set(port_main.COMMANDS) | {"manifests"}


# ---- the commands as processes --------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def cluster():
    """A port ``RestCluster`` with the cluster's admission and its fake
    kubelet serving on a thread; stopped at teardown."""
    c = RestCluster("port", admission=True, kubelet=True)
    stop = threading.Event()
    kubelet = threading.Thread(
        target=c.kubelet.run_forever, name="kubelet", daemon=True,
        kwargs=dict(stop=stop, poll_interval_s=0.05))
    kubelet.start()
    try:
        yield c
    finally:
        stop.set()
        c.kubelet._wake.set()
        kubelet.join(30)
        c.close()
        stop_fanout(c.api)
        assert not kubelet.is_alive()


@pytest.fixture
def procs(tmp_path):
    """Start ``chip_smoke.CPProcess``es; any still running at teardown
    is killed (and the test fails)."""
    started = []

    def start(cmd, env):
        started.append(chip_smoke.CPProcess(cmd, env, str(tmp_path)))
        return started[-1]
    yield start
    alive = [p.cmd for p in started if p.proc.poll() is None]
    for p in started:
        if p.proc.poll() is None:
            p.proc.kill()
            p.proc.wait(30)
    assert not alive, f"left running: {alive}"


def _admin(api, user=USER):
    api.ensure_namespace(NS)
    rb = make_object("rbac.authorization.k8s.io/v1", "RoleBinding",
                     "ns-admin", NS)
    rb["roleRef"] = {"kind": "ClusterRole", "name": "kubeflow-admin"}
    rb["subjects"] = [{"kind": "User", "name": user}]
    api.create(rb)


def _stopped(proc):
    rc = proc.stop(60)
    assert rc == 0, proc.tail()
    return rc


def test_gateway_process_serves_shell_and_jupyter_listing(cluster, procs):
    _admin(cluster.api)
    port = _free_port()
    gw = procs("gateway", {"KUBE_API_URL": cluster.url, "PORT": str(port),
                           "DEV_USER": USER, "SECURE_COOKIES": "false"})
    user = chip_smoke.HTTPUser(f"http://127.0.0.1:{port}")
    gw.ready(lambda: chip_smoke._healthz(user.url), 60)
    status, headers, raw = user.fetch("shell", "GET", "/")
    assert status == 200 and b'src="/static/app.js"' in raw
    assert headers["Content-Type"] == "text/html; charset=utf-8"
    cookie = headers["Set-Cookie"]
    assert cookie.startswith("XSRF-TOKEN=") and "Secure" not in cookie
    # DEV_USER pins the identity whatever the client sends
    status, body = user.call("list", "GET",
                             f"/jupyter/api/namespaces/{NS}/notebooks",
                             user="mallory@corp.com")
    assert (status, body["notebooks"], body["user"]) == (200, [], USER)
    assert not gw.torch_loaded()
    _stopped(gw)


def test_controller_manager_process_reconciles_notebook_to_ready(cluster,
                                                                 procs):
    from kubeflow_rm_tpu_torch.controlplane.ha.leases import (
        DEFAULT_LEASE_NAME,
    )

    api = cluster.api
    api.ensure_namespace(NS)
    api.create(make_gpu_node("n0", "h100-80gb-1"))
    cm = procs("controller-manager", {
        "KUBE_API_URL": cluster.url, "LEADER_ELECT": "true",
        "POD_NAME": "cm-test", "RECONCILE_WORKERS": "2"})

    def holder():
        lease = api.try_get("Lease", DEFAULT_LEASE_NAME, "kubeflow")
        return lease and lease["spec"].get("holderIdentity")
    cm.ready(lambda: holder() == "cm-test", 60)
    api.create(make_notebook("nb", NS, accelerator_type="h100-80gb-1"))
    chip_smoke._poll(lambda: (api.get("Notebook", "nb", NS).get("status")
                              or {}).get("readyReplicas") == 1,
                     60, "the notebook never went Ready")
    assert api.get("Pod", "nb-0", NS)["spec"]["nodeName"] == "n0"
    assert not cm.torch_loaded()
    _stopped(cm)
    # a graceful exit gives the lease up (release_on_exit)
    assert holder() == ""


def test_webhook_server_process_answers_as_in_process(cluster, procs):
    from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import (
        KubeAPIServer,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy.webhook_server import (
        make_admission_handler,
    )

    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api

    api = cluster.api
    api.ensure_namespace(NS)
    port = _free_port()
    hook = procs("webhook-server", {"KUBE_API_URL": cluster.url,
                                    "PORT": str(port)})
    url = f"http://127.0.0.1:{port}"
    hook.ready(lambda: chip_smoke._healthz(url), 60)
    # a raw pod of a 2 x 4 slice's host 1, as the StatefulSet submits it
    raw_pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "nb-1", "namespace": NS, "labels": {
            nb_api.NOTEBOOK_NAME_LABEL: "nb",
            nb_api.TPU_ACCELERATOR_LABEL: "h100-80gb-2x4",
            "apps.kubernetes.io/pod-index": "1",
            "statefulset.kubernetes.io/pod-name": "nb-1"}},
        "spec": {"containers": [{"name": "nb", "image": "i"}],
                 "subdomain": "nb-workers"}}
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": "u1", "operation": "CREATE",
                          "object": raw_pod}}
    user = chip_smoke.HTTPUser(url)
    status, body = user.call("review", "POST", "/mutate-pod", review)
    want = make_admission_handler(KubeAPIServer(cluster.url)).review(
        "/mutate-pod", review)
    assert status == 200 and body == want
    assert body["response"]["allowed"] is True and body["response"]["patch"]
    assert not hook.torch_loaded()
    _stopped(hook)


@pytest.mark.parametrize("cmd", ["jupyter-web-app", "volumes-web-app",
                                 "tensorboards-web-app", "kfam",
                                 "dashboard"])
def test_webapp_process_serves_healthz(cluster, procs, cmd):
    port = _free_port()
    app = procs(cmd, {"KUBE_API_URL": cluster.url, "PORT": str(port)})
    app.ready(lambda: chip_smoke._healthz(f"http://127.0.0.1:{port}"), 60)
    assert not app.torch_loaded()
    _stopped(app)


def test_torch_check_sees_this_process():
    """The positive control: this process imported torch."""
    import os

    assert chip_smoke.torch_mapped(os.getpid())


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
