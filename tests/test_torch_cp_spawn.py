"""The port's spawn path end to end on the CPU: the injected env through
the launcher gives JAX's ranks, ``make_control_plane`` wires the pricer
and refuses the arms not ported yet, the serving loop runs and stops,
and the card table and the LoRA declaration the pricer takes."""

import threading

import pytest

from kubeflow_rm_tpu.parallel import distributed as jax_dist
from kubeflow_rm_tpu_torch.analysis.torchcheck import memplan, pricer
from kubeflow_rm_tpu_torch.controlplane import make_control_plane
from kubeflow_rm_tpu_torch.controlplane import scheduler, suspend
from kubeflow_rm_tpu_torch.controlplane.api import gpu
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
    make_gpu_node,
)
from kubeflow_rm_tpu_torch.launcher.torchrun import torchrun_env
from kubeflow_rm_tpu_torch.parallel import distributed as port_dist
from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, Side, jax_switch_defaults, key_map, parity,
    reset_uids, stop_fanout,
)


def _env(pod):
    return {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}


@pytest.mark.parametrize("acc,slices", [("h100-80gb-1", 1),
                                        ("h100-80gb-8", 1),
                                        ("h100-80gb-2x4", 1),
                                        ("h100-80gb-2x4", 2)])
def test_env_round_trip(parity, acc, slices):
    """Each pod's injected env, read by the port's ``tpu_env`` and turned
    into torchrun's env per card, gives the rank, world and rendezvous
    host that JAX's injector and ``tpu_env`` give its pod."""
    envs = {}
    for pkg in ("port", "jax"):
        reset_uids(parity)
        S = Side(pkg)
        try:
            S.api.ensure_namespace(NS)
            for i in range(4):
                S.node(f"n{i}", acc)
            S.api.create(S.notebook("rt", acc, num_slices=slices))
            S.run()
            envs[pkg] = {p["metadata"]["name"]: _env(p)
                         for p in S.api.list("Pod", NS)}
        finally:
            S.close()
    topo = gpu.lookup(acc)
    assert len(envs["port"]) == topo.hosts * slices
    for name, penv in envs["port"].items():
        jenv = envs["jax"][name]
        assert penv == key_map(jenv)
        pt, jt = port_dist.tpu_env(penv), jax_dist.tpu_env(jenv)
        assert (pt.worker_id, pt.worker_hostnames, pt.num_slices,
                pt.slice_id, pt.coordinator, pt.num_hosts, pt.process_id) \
            == (jt.worker_id, jt.worker_hostnames, jt.num_slices,
                jt.slice_id, jt.coordinator, jt.num_hosts, jt.process_id)
        assert (pt.accelerator_type, pt.topology) == key_map(
            (jt.accelerator_type, jt.topology))
        master = (jt.coordinator if slices > 1
                  else jt.worker_hostnames[0])
        for local in range(topo.cards_per_host):
            tr = torchrun_env(penv, cards_per_host=topo.cards_per_host,
                              local_rank=local)
            assert tr == {
                "MASTER_ADDR": master, "MASTER_PORT": "12355",
                "RANK": str(jt.process_id * topo.cards_per_host + local),
                "LOCAL_RANK": str(local),
                "WORLD_SIZE": str(jt.num_hosts * topo.cards_per_host)}


def test_refused_arms_name_their_slice():
    """No arm refuses any more. ``APIServer(shard=)`` (7e-2) names its
    shard and labels the shard's series (its WAL's, here). Suspend (7d)
    and leases (7e-1): ``enable_suspend`` adds the suspend and failover
    controllers on either cache arm, the oversubscription switch turns
    both ways (on by default, as JAX's), and ``run_forever(elector=)``
    starts the election loop and hooks the queues' resync onto it. The
    cache and culling (7b, 7c) are checked positively in
    ``test_torch_cp_cache.py`` and ``test_torch_cp_controllers.py``."""
    import tempfile

    from kubeflow_rm_tpu_torch.controlplane import metrics
    from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer

    with tempfile.TemporaryDirectory() as wal_dir:
        before = metrics.WAL_BYTES_TOTAL.get(shard="shard-0")
        sharded = APIServer(shard="shard-0", wal_dir=wal_dir)
        try:
            assert sharded.shard == "shard-0"
            sharded.ensure_namespace("s")
            assert metrics.WAL_BYTES_TOTAL.get(shard="shard-0") > before
        finally:
            sharded.close_persistence()
            stop_fanout(sharded)
    for cache in (True, False):
        api, mgr = make_control_plane(cache=cache, enable_suspend=True)
        stop_fanout(api)
        assert [type(c).__name__ for c in mgr.controllers][-2:] == [
            "SuspendController", "ReplicaFailoverController"]
    assert suspend.oversubscribe() is True
    try:
        suspend.set_oversubscribe(False)
        assert suspend.oversubscribe() is False
    finally:
        suspend.set_oversubscribe(True)

    class Elector:
        identity, is_leader = "probe", False

        def __init__(self):
            self.on_started_leading, self.on_stopped_leading = [], []
            self.ran = threading.Event()

        def run(self, stop):
            self.ran.set()

    el, stop = Elector(), threading.Event()
    stop.set()
    api, mgr = make_control_plane(cache=False)
    try:
        mgr.run_forever(stop=stop, elector=el)
        assert el.ran.wait(30)
        assert len(el.on_started_leading) == 1
        assert len(el.on_stopped_leading) == 1
    finally:
        stop_fanout(api)


def test_make_control_plane_prices_binds_stops_and_collects(parity):
    """The chip smoke's controlplane phase at a small size: a priced
    notebook on one card's node, fit, bound with the card and the
    selector, the env injected; stop gives the card back; delete
    collects the children."""
    decl = ('{"preset": "tiny", "optim": "adamw", "batch": 2, '
            '"grad_accum": 1, "remat": "dots", "seq": 128, '
            '"lora_rank": 4}')
    api, mgr = make_control_plane(FakeClock(), cache=False)
    try:
        api.ensure_namespace(NS)
        api.create(make_gpu_node("gpu-0", "h100-80gb-1"))
        api.create(nb_api.make_notebook(
            "ft", NS, accelerator_type="h100-80gb-1",
            annotations={gpu.DECLARED_WORKLOAD_ANNOTATION: decl}))
        mgr.run_until_idle()
        nb = api.get(nb_api.KIND, "ft", NS)
        adm = nb["status"]["admission"]
        assert adm["verdict"] == "fit"
        assert adm["workload"]["lora_rank"] == 4
        ann = nb["metadata"]["annotations"]
        assert ann[gpu.PREDICTED_HBM_ANNOTATION] == str(
            adm["predicted_peak_gb"])
        assert nb["status"]["readyReplicas"] == 1
        pod = api.get("Pod", "ft-0", NS)
        assert pod["spec"]["nodeName"] == "gpu-0"
        assert pod["spec"]["containers"][0]["resources"]["limits"] == {
            "nvidia.com/gpu": "1"}
        assert pod["spec"]["nodeSelector"] == {
            gpu.NODE_LABEL_ACCELERATOR: "nvidia-h100-80gb"}
        env = _env(pod)
        assert env["TPU_WORKER_ID"] == "0"
        assert env["TPU_WORKER_HOSTNAMES"] == \
            "ft-0.ft-workers.user1.svc.cluster.local"
        assert pod["metadata"]["annotations"][
            gpu.PREDICTED_HBM_ANNOTATION] == \
            f"{adm['predicted_peak_gb']:.4f}"
        sched = scheduler.cache_for(api)
        assert sched.stats()["free_chips"] == 0.0

        nb["metadata"]["annotations"][nb_api.STOP_ANNOTATION] = "now"
        api.update(nb)
        mgr.run_until_idle()
        assert api.get("StatefulSet", "ft", NS)["spec"]["replicas"] == 0
        assert api.try_get("Pod", "ft-0", NS) is None
        assert sched.stats()["free_chips"] == 1.0

        api.delete(nb_api.KIND, "ft", NS)
        mgr.run_until_idle()
        assert [k for k in ("StatefulSet", "Service", "VirtualService",
                            "Pod") if api.list(k, NS)] == []
    finally:
        stop_fanout(api)


def test_run_forever_serves_and_stops(parity):
    """The serving loop (no elector) spawns a notebook from watch events
    and stops when asked; its thread is joined."""
    api, mgr = make_control_plane(cache=False)
    ready, stop = threading.Event(), threading.Event()

    def watch(etype, obj, old):
        if obj.get("kind") == nb_api.KIND and (
                obj.get("status") or {}).get("readyReplicas") == 1:
            ready.set()

    api.add_watcher(watch, name="probe")
    errors = []
    loop = threading.Thread(target=mgr.run_forever, kwargs=dict(
        stop=stop, poll_interval_s=0.05,
        on_error=lambda *e: errors.append(e)), name="manager-loop")
    loop.start()
    try:
        api.ensure_namespace(NS)
        api.create(make_gpu_node("gpu-0", "h100-80gb-8"))
        api.create(nb_api.make_notebook("live", NS,
                                        accelerator_type="h100-80gb-8"))
        assert ready.wait(60), "the notebook never became ready"
    finally:
        stop.set()
        mgr._wake.set()
        loop.join(60)
        stop_fanout(api)
    assert not loop.is_alive() and errors == []


def test_gpu_table_and_nodes():
    t = gpu.lookup("h100-80gb-2x4")
    assert (t.cards, t.hosts, t.cards_per_host, t.topology,
            t.multihost) == (8, 2, 4, "4", True)
    assert gpu.lookup("h100-80gb-2x8").cards_per_host == 8
    assert t.hbm_gib_per_host == 4 * gpu.H100_80GB_GIB
    assert gpu.by_node_labels("nvidia-h100-80gb", "4").accelerator_type \
        == "h100-80gb-4"
    assert gpu.by_node_labels("nvidia-h100-80gb", "3") is None
    node = make_gpu_node("n", "h100-80gb-2x4")
    assert node["metadata"]["labels"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "nvidia.com/gpu.count": "4"}
    assert node["status"]["allocatable"]["nvidia.com/gpu"] == "4"
    assert float(node["status"]["allocatable"][
        "nvidia.com/gpu-memory-gib"]) == 4 * gpu.H100_80GB_GIB


def test_lora_declaration_walks_the_adapted_step():
    """``lora_rank`` prices the frozen base with adapters on wq/wv: the
    walk the pricer caches equals memplan's walk of that tree."""
    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig

    raw = {"preset": "tiny", "optim": "adamw", "batch": 2,
           "grad_accum": 1, "remat": "dots", "seq": 128, "lora_rank": 4}
    decl = pricer.parse(raw)
    assert decl.to_dict()["lora_rank"] == 4
    assert "lora_rank" not in pricer.parse(
        dict(raw, lora_rank=0)).to_dict()
    model = memplan.model_config("tiny", "dots", 128)
    tcfg = TrainConfig(model=model, optim=OptimConfig(
        factored=False, train_only="lora"))
    want = memplan.walk_train_step(
        tcfg, 2, 1, params_fn=lambda g: add_lora(
            init_params(model, g, "meta"), 4, generator=g,
            targets=("wq", "wv")))
    pricer.cache_clear()
    got = pricer._walk(decl)
    assert got["peak_bytes"] == want["peak_bytes"]
    assert got["flops_per_step"] == want["flops_per_step"]
    full = pricer._walk(pricer.parse(dict(raw, lora_rank=0)))
    assert got["grads_bytes"] < full["grads_bytes"]
    assert got["opt_state_bytes"] < full["opt_state_bytes"]
    for bad in ({"lora_rank": -1}, {"lora_rank": 4096},
                {"lora_rank": 4, "offload": "optimizer"}):
        with pytest.raises(pricer.DeclarationError):
            pricer.parse(dict(raw, **bad))


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
