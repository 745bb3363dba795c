"""The port's ``utils/profiling.py`` and ``utils/pytree.py`` against the
JAX package's: the same ``PhaseRecorder`` summaries for the same
recorded values, a Chrome trace written on the CPU with nested
``annotate`` regions, ``profile_wsgi``'s table, and the tree sizes and
casts of the same arrays.

Tolerance: none — the summaries are the same arithmetic on the same
floats, and the tree counts are integers.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.utils import profiling as jprof
from kubeflow_rm_tpu.utils import pytree as jtree
from kubeflow_rm_tpu_torch.utils import profiling as tprof
from kubeflow_rm_tpu_torch.utils import pytree as ttree


@pytest.mark.parametrize("n", [1, 2, 7, 20, 101])
def test_phase_recorder_summary_equals_jax(n):
    rng = np.random.default_rng(n)
    vals = rng.exponential(0.05, size=n).tolist()
    j, t = jprof.PhaseRecorder(), tprof.PhaseRecorder()
    for i, v in enumerate(vals):
        for rec in (j, t):
            rec.record("phase-a" if i % 3 else "phase-b", v)
    assert t.summary() == j.summary()
    jo, to = jprof.PhaseRecorder(), tprof.PhaseRecorder()
    jo.record("phase-a", 0.5)
    to.record("phase-a", 0.5)
    j.merge(jo)
    t.merge(to)
    assert t.summary() == j.summary()


def test_phase_context_records_a_sample():
    rec = tprof.PhaseRecorder()
    with rec.phase("x"):
        pass
    s = rec.summary()["x"]
    assert s["count"] == 1 and s["max_ms"] >= 0.0


def _events(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        y = x @ x
    assert y.shape == (64, 64)
    path = prof.trace_path
    assert path.startswith(str(tmp_path)) and path.endswith(".json")
    names = {e.get("name") for e in _events(path)}
    assert "aten::mm" in names
    # two traces in one process never overwrite each other
    with tprof.trace(str(tmp_path)) as again:
        x + 1
    assert again.trace_path != path


def test_annotate_nests(tmp_path):
    x = torch.randn(32, 32)
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("outer"):
            with tprof.annotate("inner"):
                x @ x
    ev = {e["name"]: e for e in _events(prof.trace_path)
          if e.get("name") in ("outer", "inner", "aten::mm")}
    assert set(ev) == {"outer", "inner", "aten::mm"}

    def span(e):
        return e["ts"], e["ts"] + e["dur"]

    (o0, o1), (i0, i1), (m0, m1) = (span(ev[k]) for k in
                                    ("outer", "inner", "aten::mm"))
    assert o0 <= i0 <= m0 and m1 <= i1 <= o1


def test_profile_wsgi_prints_the_stats_table():
    with tprof.profile_wsgi(limit=5) as out:
        sum(range(1000))
    assert "function calls" in out.getvalue()


def test_pytree_sizes_and_casts_equal_jax():
    rng = np.random.default_rng(0)
    arrays = {"embed": {"tokens": rng.standard_normal((16, 8))
                        .astype(np.float32)},
              "blocks": {"wq": rng.standard_normal((2, 8, 8))
                         .astype(np.float32),
                         "q8": rng.integers(-127, 127, (2, 8))
                         .astype(np.int8)},
              "ids": [rng.integers(0, 9, (5,)).astype(np.int32)]}
    jt = jax.tree.map(jnp.asarray, arrays)
    tt = {"embed": {"tokens": torch.from_numpy(arrays["embed"]["tokens"])},
          "blocks": {k: torch.from_numpy(v)
                     for k, v in arrays["blocks"].items()},
          "ids": [torch.from_numpy(arrays["ids"][0])]}
    assert ttree.param_count(tt) == jtree.param_count(jt)
    assert ttree.tree_size_bytes(tt) == jtree.tree_size_bytes(jt)
    jc, tc = jtree.tree_cast(jt, jnp.bfloat16), ttree.tree_cast(
        tt, torch.bfloat16)
    assert ttree.tree_size_bytes(tc) == jtree.tree_size_bytes(jc)
    assert tc["blocks"]["q8"].dtype == torch.int8        # uncast
    assert tc["ids"][0].dtype == torch.int32
    assert tc["blocks"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tc["blocks"]["wq"].float().numpy(),
        np.asarray(jc["blocks"]["wq"].astype(jnp.float32)))
