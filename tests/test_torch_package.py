"""Package rules of the PyTorch port: it imports no JAX, nothing of the
JAX package, neither optax nor orbax (both import JAX) and none of
prometheus_client, torch_xla, werkzeug and ml_dtypes (the card's machine
has none of them), by statement or by name, it never
runs on the CPU unless asked, and on the CPU the flash op never tries
to build or launch its CUDA kernels, forward or backward."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubeflow_rm_tpu_torch.device import default_device
from kubeflow_rm_tpu_torch.kernels import build
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, init_params
from kubeflow_rm_tpu_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "kubeflow_rm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    """Every module ``path`` imports: its import statements, and the
    constant names it passes to ``importlib.import_module`` or
    ``__import__`` (a module loaded by name escapes the statements)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(
                    arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


def test_import_scan_sees_modules_loaded_by_name(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import importlib\n"
                   "w = importlib.import_module('werkzeug.routing')\n"
                   "y = __import__('yaml')\n")
    assert set(_imported_modules(src)) == {"importlib", "werkzeug.routing",
                                           "yaml"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        # prometheus_client, torch_xla, werkzeug and ml_dtypes are not on
        # the card's machine
        assert top not in ("jax", "jaxlib", "kubeflow_rm_tpu", "optax",
                           "orbax", "prometheus_client", "torch_xla",
                           "werkzeug", "ml_dtypes"), \
            f"{path.name} imports {mod}"


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    for name in build.SIGNATURES:
        assert (build.CSRC / f"{name}.cu").exists()
    assert set(build.SIGNATURES) == {"flash_fwd", "flash_bwd"}
    # the import rule above reaches every subpackage of the port
    packages = {p.parent.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"kubeflow_rm_tpu_torch/training", "kubeflow_rm_tpu_torch/utils",
            "kubeflow_rm_tpu_torch/models", "kubeflow_rm_tpu_torch/ops",
            "kubeflow_rm_tpu_torch/analysis/torchcheck"} <= packages
    # the auditor's modules, each the counterpart of a JAX module
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("__init__", "__main__", "costmodel", "memplan", "pricer",
                "hostsync", "recompile"):
        assert f"kubeflow_rm_tpu_torch/analysis/torchcheck/{mod}.py" in names
    assert {"kubeflow_rm_tpu_torch/utils/profiling.py",
            "kubeflow_rm_tpu_torch/utils/pytree.py"} <= names
    # the lint gate, the control-plane seams and the launcher
    for mod in ("__init__", "__main__", "base", "rules"):
        assert f"kubeflow_rm_tpu_torch/analysis/lint/{mod}.py" in names
    assert {f"kubeflow_rm_tpu_torch/{f}" for f in (
        "controlplane/webhook/admission_pricer.py",
        "controlplane/obs/slo.py", "controlplane/metrics.py",
        "controlplane/api/gpu.py", "launcher/agent.py",
        "launcher/torchrun.py")} <= names
    # the serving fleet and what it stands on: the lock factory, the
    # ring, the rate limiter, tracing, the gateway
    assert {f"kubeflow_rm_tpu_torch/{f}" for f in (
        "analysis/lockgraph.py", "controlplane/shard/ring.py",
        "controlplane/deploy/kubeclient.py", "controlplane/tracing.py",
        "controlplane/webapps/serving.py",
        "controlplane/serving_fleet.py")} <= names
    assert {"kubeflow_rm_tpu_torch/controlplane/shard",
            "kubeflow_rm_tpu_torch/controlplane/deploy",
            "kubeflow_rm_tpu_torch/controlplane/webapps"} <= packages
    # the control plane's spawn path, each at the JAX module's path
    # (the TPU injector's counterpart is webhook/gpu_inject.py)
    assert {f"kubeflow_rm_tpu_torch/controlplane/{f}" for f in (
        "__init__.py", "api/meta.py", "api/gpu.py", "api/notebook.py",
        "api/tpujob.py", "metrics.py", "chaos.py", "ha/__init__.py",
        "ha/workqueue.py", "apiserver.py", "runtime.py", "scheduler.py",
        "suspend.py", "webhook/gpu_inject.py", "controllers/__init__.py",
        "controllers/notebook.py", "controllers/statefulset.py")} <= names
    assert {"kubeflow_rm_tpu_torch/controlplane/ha",
            "kubeflow_rm_tpu_torch/controlplane/controllers"} <= packages
    # suspend/resume and harvest (7d); the WAL and snapshots, leader
    # election and CRD conversion (7e-1)
    assert {f"kubeflow_rm_tpu_torch/controlplane/{f}" for f in (
        "suspend.py", "harvest.py", "persistence/__init__.py",
        "persistence/wal.py", "persistence/snapshot.py", "ha/leases.py",
        "api/conversion.py")} <= names
    assert "kubeflow_rm_tpu_torch/controlplane/persistence" in packages
    # the deployed layout (7e-2): the kube adapter and its shard router,
    # the REST facade, the webhook server, the CRDs and the manifests
    assert {f"kubeflow_rm_tpu_torch/controlplane/{f}" for f in (
        "deploy/__init__.py", "deploy/kubeclient.py", "deploy/restserver.py",
        "deploy/webhook_server.py", "deploy/crds.py", "deploy/manifests.py",
        "shard/__init__.py", "shard/ring.py")} <= names
    # the shard processes (7e-3): the worker, its supervisor and the
    # elastic split/merge with the autoscaler
    assert {f"kubeflow_rm_tpu_torch/controlplane/shard/{f}.py" for f in (
        "worker", "runner", "elastic")} <= names
    # the observability loop (7f-1): the TSDB, the SLO engine, the
    # flight recorder, run_meta and the Observer, each at JAX's path
    assert {f"kubeflow_rm_tpu_torch/controlplane/obs/{f}.py" for f in (
        "__init__", "timeseries", "slo", "flight", "runmeta")} <= names
    # the web apps (7f-2a): the kit, the status ladder, the readiness
    # hub, the spawner with its JSON config, volumes, tensorboards and
    # KFAM, each at JAX's path
    assert {f"kubeflow_rm_tpu_torch/controlplane/webapps/{f}.py" for f in (
        "__init__", "core", "status", "readiness", "jupyter", "volumes",
        "tensorboards", "kfam")} <= names
    assert (ROOT / "kubeflow_rm_tpu_torch/controlplane/webapps/"
                   "spawner_ui_config.json").exists()
    # the browser-facing layer and the entry point (7f-2b): the metrics
    # service, the dashboard with its SPA, the gateway and ``__main__``
    assert {f"kubeflow_rm_tpu_torch/controlplane/{f}.py" for f in (
        "webapps/metrics_service", "webapps/dashboard", "webapps/gateway",
        "__main__")} <= names
    for f in ("app.js", "index.html", "style.css"):
        assert (ROOT / "kubeflow_rm_tpu_torch/controlplane/webapps/static"
                / f).is_file()
    # ... and ship in the package beside the spawner's config
    data = [ln for ln in (ROOT / "pyproject.toml").read_text().splitlines()
            if ln.startswith('"kubeflow_rm_tpu_torch.controlplane.webapps"')]
    assert data == ['"kubeflow_rm_tpu_torch.controlplane.webapps" = '
                    '["*.json", "static/*"]']


#: a JAX file's path → its counterpart's in the port
RENAMES = {
    "api/tpu.py": "api/gpu.py",
    "webhook/tpu_inject.py": "webhook/gpu_inject.py",
    "launcher/torchxla.py": "launcher/torchrun.py",
    "webapps/spawner_ui_config.yaml": "webapps/spawner_ui_config.json",
    "analysis/jaxcheck/": "analysis/torchcheck/",
}
#: JAX files without a counterpart: the lock hierarchy's table is folded
#: into the port's ``analysis/lockgraph.py``
JAX_ONLY = {"analysis/hierarchy.py"}
#: the port's files without a JAX counterpart: the kernels and their
#: build, the device choice, the CLIs and the port's own helpers
PORT_ONLY = {
    "device.py", "finetune.py", "serve.py", "kernels/__init__.py",
    "kernels/build.py", "kernels/csrc/flash_bwd.cu",
    "kernels/csrc/flash_fwd.cu", "kernels/csrc/hopper.cuh",
    "models/params.py", "models/remat.py", "parallel/collectives.py",
    "parallel/sharded.py",
}


def _package_files(name: str) -> set[str]:
    root = ROOT / name
    return {p.relative_to(root).as_posix() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts
            and p.suffix != ".pyc"
            and "_build" not in p.relative_to(root).parts}


def test_file_lists_equal_under_the_renames():
    """Every file of the JAX package has its counterpart in the port at
    the same path under :data:`RENAMES` but :data:`JAX_ONLY`, and the
    port has no file JAX lacks but :data:`PORT_ONLY`."""
    def rename(path):
        for old, new in RENAMES.items():
            if path.endswith(old) or path.startswith(old):
                path = path.replace(old, new)
        return path
    jax = {rename(f) for f in _package_files("kubeflow_rm_tpu")}
    port = _package_files("kubeflow_rm_tpu_torch")
    assert jax - port == JAX_ONLY
    assert port - jax == PORT_ONLY


def test_shard_modules_keep_jax_public_names():
    """The shard processes and the observability loop sit at JAX's paths
    with JAX's public names (the port's ``obs`` exports every name of
    JAX's ``__all__``), and the router has the elastic verbs the handoff
    drives."""
    import importlib

    for mod, names in (
            ("shard", ("ShardRunner", "HashRing", "DEFAULT_VNODES")),
            ("shard.worker", ("shard_worker_main", "LEASE_DURATION_S",
                              "LEASE_RENEW_S", "LEASE_RETRY_S")),
            ("shard.runner", ("ShardRunner",)),
            ("shard.elastic", ("ElasticShardManager", "ShardAutoscaler",
                               "partition_key", "LOCAL_KINDS")),
            ("obs", tuple(importlib.import_module(
                "kubeflow_rm_tpu.controlplane.obs").__all__)),
            ("tracing", ("SpanCollector", "critical_path", "merge_spans",
                         "current_span", "current_context"))):
        port = importlib.import_module(f"kubeflow_rm_tpu_torch.controlplane."
                                       f"{mod}")
        for name in names:
            assert hasattr(port, name), f"{mod}.{name}"
    from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import (
        ShardedKubeAPIServer,
    )
    for verb in ("fence", "unfence", "set_topology"):
        assert callable(getattr(ShardedKubeAPIServer, verb))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_yaml_imports(path):
    """The port writes its CRDs and manifests as JSON (which a YAML 1.2
    reader takes): no module imports PyYAML, which the card's machine
    need not have."""
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("yaml", "ruamel"), \
            f"{path.name} imports {mod}"


def test_web_apps_and_the_control_plane_load_no_torch():
    """The web apps, the gateway, the entry point and the controllers
    (``profile`` takes the identity header from ``webapps/core``, which
    builds on ``webapps/serving``'s WSGI surface) import no torch: a
    shard worker or a web-app process starts without CUDA's libraries.
    A dashboard made and read loads none either (its ``Observer`` bridges
    the torch-free probes of ``analysis/torchcheck``)."""
    mods = ["kubeflow_rm_tpu_torch.controlplane.controllers.profile",
            "kubeflow_rm_tpu_torch.controlplane.__main__"] + [
        f"kubeflow_rm_tpu_torch.controlplane.webapps.{m}" for m in (
            "core", "status", "readiness", "jupyter", "volumes",
            "tensorboards", "kfam", "metrics_service", "dashboard",
            "gateway")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from kubeflow_rm_tpu_torch.controlplane.apiserver import "
            "APIServer\n"
            "from kubeflow_rm_tpu_torch.controlplane.webapps import gateway\n"
            "gw = gateway.make_gateway(APIServer(), dev_user='a@b.c')\n"
            "from kubeflow_rm_tpu_torch.controlplane.webapps.core import "
            "Client\n"
            "c = Client(gw)\n"
            "for u in ('/', '/api/metrics', '/api/metrics/history', "
            "'/api/alerts', '/api/harvest', '/api/traces'):\n"
            "    assert c.get(u).status_code == 200, u\n"
            "gw.app.metrics_history.stop()\n"
            "print('torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(LlamaConfig.tiny(), torch.Generator())


def test_cpu_flash_never_builds_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path tried to build the kernel")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "_start", refuse)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [w.launches for w in wrappers]
    q = torch.randn(1, 128, 2, 64, generator=torch.Generator().manual_seed(0))
    q = q.bfloat16().requires_grad_(True)
    out = fa.flash_attention(q, q, q)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert [w.launches for w in wrappers] == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the wrapper: the choice of the plain version is
    made by the caller, from the tensor's device."""
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, q, q, heads=1, group=1, causal=True)


def test_library_path_tracks_source_and_flags(monkeypatch):
    p = build.library_path("flash_fwd")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libflash_fwd-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("flash_fwd") != p


def test_build_dir_is_ignored():
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "kubeflow_rm_tpu_torch/kernels/_build/" in ignored


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke script exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
