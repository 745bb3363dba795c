"""Port parity of the mesh plumbing (``kubeflow_rm_tpu_torch.parallel.
{distributed,mesh,sharding,collectives}``) against the JAX package.

- ``tpu_env``/``initialize``: JAX's six ``test_distributed.py`` cases, with
  ``init_process_group`` monkeypatched (no process group is made), plus
  the torchrun env and the multislice coordinator.
- ``MeshConfig.resolve``: the same sizes and the same error texts.
- ``param_pspecs``: spec for spec equal to JAX's on the tiny tree, its
  LoRA, int8 and int4 forms and ``tiny_moe``; ``param_shardings``' q4
  fallback (packed axis, or replicated with JAX's warning) and the
  demotion of scales, equal to JAX's ``NamedSharding`` specs.
- On gloo worlds of 2 and 4 processes (``torch_mesh_ranks``): each
  rank's mesh coordinates equal the position of its device in JAX's
  ``make_mesh`` layout over as many virtual devices; the refusals of
  ``make_mesh``/``make_hybrid_mesh``; every autograd collective's output
  and input gradient, exact (float32 sums of two or four terms, each
  side computing the same sum).
"""

import math
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import lora as jlora
from kubeflow_rm_tpu.models import mixtral as jmixtral
from kubeflow_rm_tpu.models import quantize as jquant
from kubeflow_rm_tpu.parallel import distributed as jdist
from kubeflow_rm_tpu.parallel import mesh as jmesh
from kubeflow_rm_tpu.parallel import sharding as jsharding
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
from kubeflow_rm_tpu_torch.models.mixtral import MixtralConfig
from kubeflow_rm_tpu_torch.models.params import from_numpy_params
from kubeflow_rm_tpu_torch.parallel import distributed as tdist
from kubeflow_rm_tpu_torch.parallel import mesh as tmesh
from kubeflow_rm_tpu_torch.parallel import sharding as tsharding

from torch_mesh_ranks import start_worlds


# ---------------------------------------------------------------------
# distributed: the webhook env and the rendezvous
# ---------------------------------------------------------------------

@pytest.fixture
def init_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


WEBHOOK_ENV = {
    "TPU_WORKER_ID": "3",
    "TPU_WORKER_HOSTNAMES": ",".join(
        f"nb-{i}.nb-workers.u.svc.cluster.local" for i in range(4)),
    "TPU_ACCELERATOR_TYPE": "v5litepod-16",
    "TPU_TOPOLOGY": "4x4",
}


@pytest.mark.parametrize("env", [
    {}, WEBHOOK_ENV, {"TPU_WORKER_HOSTNAMES": "a,,b,"},
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "w0,w1",
     "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
     "MEGASCALE_COORDINATOR_ADDRESS": "coord"},
], ids=["empty", "webhook", "empty-entries", "multislice"])
def test_tpu_env_equals_jax(env):
    te, je = tdist.tpu_env(env), jdist.tpu_env(env)
    for f in ("worker_id", "worker_hostnames", "accelerator_type",
              "topology", "num_slices", "slice_id", "coordinator",
              "hosts_per_slice", "num_hosts", "process_id", "is_multihost",
              "is_multislice"):
        assert getattr(te, f) == getattr(je, f), f


def test_tpu_env_defaults_single_host():
    te = tdist.tpu_env({})
    assert te.worker_id == 0
    assert te.worker_hostnames == []
    assert te.num_hosts == 1
    assert not te.is_multihost
    assert te.accelerator_type is None


def test_tpu_env_parses_webhook_injection():
    te = tdist.tpu_env(WEBHOOK_ENV)
    assert te.worker_id == 3
    assert te.num_hosts == 4
    assert te.is_multihost
    assert te.worker_hostnames[0] == "nb-0.nb-workers.u.svc.cluster.local"
    assert te.accelerator_type == "v5litepod-16"
    assert te.topology == "4x4"


def test_tpu_env_ignores_empty_hostname_entries():
    te = tdist.tpu_env({"TPU_WORKER_HOSTNAMES": "a,,b,"})
    assert te.worker_hostnames == ["a", "b"]
    assert te.num_hosts == 2


def test_initialize_single_host_is_noop(init_calls):
    te = tdist.initialize({}, device="cpu")
    assert init_calls == []
    assert te.num_hosts == 1


def test_initialize_multihost_uses_worker0_as_coordinator(init_calls):
    env = {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "w0.svc,w1.svc"}
    tdist.initialize(env, device="cpu")
    assert init_calls == [{
        "backend": "gloo",
        "init_method": f"tcp://w0.svc:{tdist.DEFAULT_COORDINATOR_PORT}",
        "world_size": 2,
        "rank": 1,
    }]
    assert tdist.DEFAULT_COORDINATOR_PORT == jdist.DEFAULT_COORDINATOR_PORT


def test_initialize_multislice_uses_the_coordinator(init_calls):
    env = {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "w0,w1",
           "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
           "MEGASCALE_COORDINATOR_ADDRESS": "coord"}
    tdist.initialize(env, port=1234, device="cpu")
    assert init_calls == [{"backend": "gloo",
                           "init_method": "tcp://coord:1234",
                           "world_size": 4, "rank": 3}]


def test_initialize_torchrun_env_wins(init_calls):
    env = {**WEBHOOK_ENV, "RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
           "MASTER_ADDR": "m0", "MASTER_PORT": "29500"}
    te = tdist.initialize(env, device="cpu")
    assert init_calls == [{"backend": "gloo", "init_method": "tcp://m0:29500",
                           "world_size": 8, "rank": 5}]
    assert te.worker_id == 3          # the webhook env is still returned


def test_initialize_picks_nccl_for_the_card():
    assert tdist.backend_for(torch.device("cuda")) == "nccl"
    assert tdist.backend_for(torch.device("cpu")) == "gloo"


def test_tpuenv_is_frozen_dataclass():
    te = tdist.TpuEnv(worker_id=0, worker_hostnames=[],
                      accelerator_type=None, topology=None)
    with pytest.raises(Exception):
        te.worker_id = 1


def test_world_without_a_group_is_one():
    assert tdist.world_size() == 1 and tdist.rank() == 0


# ---------------------------------------------------------------------
# MeshConfig
# ---------------------------------------------------------------------

RESOLVE_CASES = [
    (dict(dp=2, fsdp=2, sp=1, tp=2), 8), (dict(dp=1, fsdp=-1, tp=2), 8),
    (dict(dp=3, fsdp=1, sp=1, tp=1), 8), (dict(dp=-1, fsdp=-1), 8),
    (dict(fsdp=-1, tp=3), 8), (dict(ep=2, sp=2), 4), (dict(), 1),
    (dict(dp=2, fsdp=2), 2),
]


@pytest.mark.parametrize("axes,n", RESOLVE_CASES)
def test_mesh_config_resolve_equals_jax(axes, n):
    def outcome(cls):
        try:
            return cls(**axes).resolve(n)
        except ValueError as e:
            return ("error", str(e))

    assert outcome(tmesh.MeshConfig) == outcome(jmesh.MeshConfig)
    assert tmesh.AXES == jmesh.AXES


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(tmesh.MeshConfig(fsdp=1), device="cpu")


# ---------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, path + "/"))
        else:
            out[path] = v
    return out


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jsharding._path_str(p): tuple(s) for p, s in flat}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _trees():
    """name -> (JAX tree (numpy), port config)."""
    key = jax.random.key(0)
    jcfg = jllama.LlamaConfig.tiny()
    base = jllama.init_params(jcfg, key)
    moe_cfg = jmixtral.MixtralConfig.tiny_moe()
    moe = jmixtral.init_params(moe_cfg, key)
    lora = jlora.add_lora(base, 4, key=jax.random.key(1),
                          targets=("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                   "w_down"))
    return {
        "tiny": (base, LlamaConfig.tiny()),
        "lora": (lora, LlamaConfig.tiny()),
        "int8": (jquant.quantize_params(base, bits=8), LlamaConfig.tiny()),
        "int4": (jquant.quantize_params(base, bits=4, group_size=16),
                 LlamaConfig.tiny()),
        "int4_lora": (jlora.add_lora(jquant.quantize_params(base, bits=4),
                                     4, key=jax.random.key(1)),
                      LlamaConfig.tiny()),
        "tiny_moe": (moe, MixtralConfig.tiny_moe()),
        "moe_int8": (jquant.quantize_params(moe, bits=8),
                     MixtralConfig.tiny_moe()),
    }


TREES = _trees()


@pytest.mark.parametrize("name", sorted(TREES))
def test_param_pspecs_equal_jax(name):
    jtree, cfg = TREES[name]
    jspecs = _jax_specs(jsharding.param_pspecs(jtree))
    port = from_numpy_params(_np_tree(jtree), cfg, "cpu")
    tspecs = _flat(tsharding.param_pspecs(port))
    assert tspecs == jspecs


def _fake_mesh(**axes):
    """What the port's sharding functions read of a mesh (names and
    sizes), without a process group."""
    sizes = [axes.get(a, 1) for a in tmesh.AXES]
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXES,
                                 mesh=torch.empty(sizes))


# (tree, mesh axes): int4 whose group axis (a) divides, (b) falls back to
# the packed axis, (c) divides neither (replicated with a warning)
SHARDING_CASES = {
    "int4_divides": ("int4", dict(fsdp=2, tp=2)),
    "int4_packed_fallback": ("int4_g64", dict(fsdp=1, tp=4)),
    "int4_replicated": ("int4_g64", dict(fsdp=1, tp=3)),
    "int8_fsdp4": ("int8", dict(fsdp=4)),
    "moe_ep2_tp2": ("tiny_moe", dict(ep=2, tp=2)),
    "lora_fsdp2_tp2": ("lora", dict(fsdp=2, tp=2)),
}


def _sharding_tree(name):
    if name == "int4_g64":
        jtree, cfg = TREES["tiny"]
        return jquant.quantize_params(jtree, bits=4, group_size=64), cfg
    return TREES[name]


@pytest.mark.parametrize("case", sorted(SHARDING_CASES))
def test_param_shardings_equal_jax(case, devices8):
    tree_name, axes = SHARDING_CASES[case]
    jtree, cfg = _sharding_tree(tree_name)
    n = math.prod(axes.values())
    jm = jmesh.make_mesh(jmesh.MeshConfig(**{"fsdp": 1, **axes}),
                         devices8[:n])
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jsh = jsharding.param_shardings(jtree, jm)
    jspecs = {k: tuple(v.spec) for k, v in _flat_shardings(jsh).items()}
    port = from_numpy_params(_np_tree(jtree), cfg, "cpu")
    mesh = _fake_mesh(**axes)
    tspecs, tw = {}, []
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        for key, t in _flat(port).items():
            try:
                tspecs[key] = tsharding.effective_spec(key, t.shape, mesh)
            except ValueError:
                # a regular weight that does not divide: the port raises
                # where JAX's device_put would; only quantized leaves adapt
                assert not key.endswith(("/q4", "/s"))
                tspecs[key] = jspecs[key]
    # JAX pads a spec's trailing Nones away; compare on the leaf's rank
    for key, spec in jspecs.items():
        want = spec + (None,) * (len(tspecs[key]) - len(spec))
        assert tspecs[key] == want, key
    assert sorted(str(w.message) for w in tw) == sorted(
        str(w.message) for w in jw)
    if case == "int4_replicated":
        assert any("neither group" in str(w.message) for w in tw)


def _flat_shardings(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jsharding._path_str(p): s for p, s in flat}


def test_param_shardings_refuses_an_indivisible_regular_weight():
    port = from_numpy_params(_np_tree(TREES["tiny"][0]), LlamaConfig.tiny(),
                             "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tsharding.param_shardings(port, _fake_mesh(tp=3))


def test_batch_pspec_equals_jax():
    for seq in (True, False):
        assert tsharding.batch_pspec(seq) == tuple(jsharding.batch_pspec(seq))


def test_rules_table_equals_jax():
    assert {k: tuple(v) for k, v in jsharding._LLAMA_RULES.items()} == \
        tsharding._LLAMA_RULES


# ---------------------------------------------------------------------
# gloo worlds: mesh layout, refusals, collectives
# ---------------------------------------------------------------------

LAYOUTS = {2: [dict(fsdp=2), dict(tp=2), dict(dp=2)],
           4: [dict(dp=2, fsdp=2), dict(fsdp=2, tp=2), dict(dp=2, sp=2),
               dict(ep=2, tp=2), dict(fsdp=4)]}


def _collective_inputs(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3, 4 * n)).astype(np.float32)
    g = rng.standard_normal((n, 3 * 4 * n * n)).astype(np.float32)
    return x, g


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    specs = {}
    for n, layouts in LAYOUTS.items():
        x, g = _collective_inputs(n)
        cases = [(f"layout{i}", "mesh_layout", {"axes": a})
                 for i, a in enumerate(layouts)]
        cases.append(("collectives", "collectives", {"x": x, "g": g}))
        if n == 2:
            cases.append(("errors", "mesh_errors", {}))
        specs[n] = cases
    return start_worlds(specs, tmp_path_factory.mktemp("mesh"))


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


@pytest.mark.parametrize("n,i", [(n, i) for n, ls in LAYOUTS.items()
                                 for i in range(len(ls))])
def test_mesh_layout_equals_jax(worlds, devices8, n, i):
    axes = LAYOUTS[n][i]
    jm = jmesh.make_mesh(jmesh.MeshConfig(**{"fsdp": 1, **axes}),
                         devices8[:n])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, got in enumerate(_ok(worlds.results()[n][f"layout{i}"])):
        coord = [int(c[0]) for c in np.nonzero(ids == devices8[rank].id)]
        assert got["shape"] == dict(jm.shape)
        assert got["index"] == dict(zip(jmesh.AXES, coord))
        for multi in ("dp/fsdp", "dp/fsdp/sp"):
            axs = multi.split("/")
            flat = 0
            for a in axs:
                flat = flat * jm.shape[a] + coord[jmesh.AXES.index(a)]
            assert got["multi_index"][multi] == flat
            assert got["multi_group_rank"][multi] == flat
            size = math.prod(jm.shape[a] for a in axs)
            assert got["multi_group_size"][multi] == size
            assert got["multi_size"][multi] == size


def test_make_mesh_refusals(worlds):
    for got in _ok(worlds.results()[2]["errors"]):
        assert got["not_covering"] == str(_resolve_error(
            dict(fsdp=3), 2))
        assert got["hybrid_dp"] == (
            "dp axis (1) must equal n_slices (2) — dp is the DCN axis in a "
            "multislice job")
        assert got["hybrid_shape"]["dp"] == 2


def _resolve_error(axes, n):
    try:
        jmesh.MeshConfig(**axes).resolve(n)
    except ValueError as e:
        return e


def _expected_collectives(x, g):
    """Each collective's output and input gradient on every rank, from
    the (world, ...) inputs and cotangents (numpy)."""
    n = x.shape[0]
    exp = {}
    cat = np.concatenate(list(x), axis=1)                # (3, 4n·n)
    total = x.sum(0)
    chunk = x.shape[2] // n

    def cot(r, shape):
        return g[r][:math.prod(shape)].reshape(shape)

    ag_grads = sum(cot(r, cat.shape) for r in range(n))
    exp["all_gather"] = [
        (cat, ag_grads[:, r * x.shape[2]:(r + 1) * x.shape[2]])
        for r in range(n)]
    rs_out = [total[:, r * chunk:(r + 1) * chunk] for r in range(n)]
    rs_cots = [cot(r, (3, chunk)) for r in range(n)]
    exp["reduce_scatter"] = [(rs_out[r], np.concatenate(rs_cots, axis=1))
                             for r in range(n)]
    exp["all_reduce"] = [(total, cot(r, total.shape)) for r in range(n)]
    cs = sum(cot(r, x.shape[1:]) for r in range(n))
    exp["copy_to_group"] = [(x[r], cs) for r in range(n)]
    exp["gather_from_group"] = [
        (cat, cot(r, cat.shape)[:, r * x.shape[2]:(r + 1) * x.shape[2]])
        for r in range(n)]
    exp["split_to_group"] = []
    for r in range(n):
        gathered = np.concatenate([cot(s, (3, chunk)) for s in range(n)],
                                  axis=1)
        exp["split_to_group"].append(
            (x[r][:, r * chunk:(r + 1) * chunk], gathered))
    exp["ppermute"] = [(x[(r - 1) % n], cot((r + 1) % n, x.shape[1:]))
                       for r in range(n)]
    # all_to_all(split 1, concat 0): rank r gets chunk r of every rank
    a2a = [np.concatenate([x[s][:, r * chunk:(r + 1) * chunk]
                           for s in range(n)], axis=0) for r in range(n)]
    exp["all_to_all"] = []
    for r in range(n):
        back = np.concatenate(
            [cot(s, a2a[s].shape)[r * 3:(r + 1) * 3] for s in range(n)],
            axis=1)
        exp["all_to_all"].append((a2a[r], back))
    return exp


COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "copy_to_group",
               "gather_from_group", "split_to_group", "ppermute",
               "all_to_all")


@pytest.mark.parametrize("n", sorted(LAYOUTS))
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_forward_and_backward(worlds, n, name):
    x, g = _collective_inputs(n)
    exp = _expected_collectives(x, g)[name]
    for r, got in enumerate(_ok(worlds.results()[n]["collectives"])):
        y, grad = exp[r]
        np.testing.assert_allclose(got[name]["y"], y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[name]["grad"], grad, rtol=1e-6,
                                   atol=1e-6)
