"""The port's lint gate (``kubeflow_rm_tpu_torch/analysis/lint``,
KFRM006-008 in their torch meaning) and its wiring into ``python -m
kubeflow_rm_tpu_torch.analysis.torchcheck``.

Each rule fires on its seeded violation (inline sources), honours
``# kfrm: disable=``, and stays quiet on the idioms next to it; the
shipped port tree lints clean; JAX's fixtures (``jax.jit`` idioms) find
nothing under the port's rules, while JAX's own rules find them."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from kubeflow_rm_tpu.analysis import lint as jlint
from kubeflow_rm_tpu_torch.analysis import lint as tlint
from kubeflow_rm_tpu_torch.analysis.lint import __main__ as lint_cli
from kubeflow_rm_tpu_torch.analysis.torchcheck import __main__ as gate

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "lint_fixtures"


def _lint(src: str, rule: str | None = None):
    return tlint.lint_source(textwrap.dedent(src), "fixture.py",
                             None if rule is None else {rule})


# the seeded violations: (rule, source, flagged lines)
KFRM006 = ("KFRM006", """\
    import numpy as np
    from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync
    from kubeflow_rm_tpu_torch.utils.profiling import annotate

    def decode(step, state, n):
        out = []
        for _ in range(n):
            with hostsync.region("engine.decode"):
                logits = step(state)
                out.append(logits.argmax(-1).tolist())
                stop = bool(logits.isnan().any())
            print(int(logits.sum()))            # outside: fine
        return out

    def train(step, state, batches):
        with annotate("train.step"):
            for b in batches:
                state, m = step(state, b)
                loss = m["loss"].item()
                arr = np.asarray(m["grad_norm"].cpu())
        return state
    """, [10, 11, 19, 20])

KFRM007 = ("KFRM007", """\
    import torch
    from torch import compile as tc

    def per_layer(layers, x):
        for layer in layers:
            fn = torch.compile(layer)
            g = torch.cuda.CUDAGraph()
            x = fn(x)
        while x.sum() > 0:
            with torch.cuda.graph(g):
                x = tc(layers[0])(x)
        return x

    _step = torch.compile(lambda x: x * 2)   # hoisted: fine
    """, [6, 7, 10, 11])

# ``compute_grads`` of the training step as it was before its
# accumulation added in place
KFRM008 = ("KFRM008", """\
    def compute_grads(params, batch, grad_accum, grads_of):
        grads, losses = None, []
        for m in range(grad_accum):
            micro = {k: v[m::grad_accum] for k, v in batch.items()}
            loss_m, aux_m, g = grads_of(params, micro)
            losses.append(loss_m)
            grads = g if grads is None else {
                k: grads[k] + g[k] for k in grads}
            del g
        grads = {k: g / grad_accum for k, g in grads.items()}
        return grads

    def carry(xs, opt_state, acc):
        for x in xs:
            opt_state = opt_state + x
            acc = [a * 0.9 + b for a, b in zip(acc, x)]
        return opt_state, acc
    """, [7, 15, 16])


@pytest.mark.parametrize("rule,src,lines", [KFRM006, KFRM007, KFRM008],
                         ids=lambda v: v if isinstance(v, str) and
                         v.startswith("KFRM") else None)
def test_rule_fires_on_its_seeded_violation(rule, src, lines):
    found = _lint(src)
    assert {f.rule for f in found} == {rule}, [f.render() for f in found]
    assert [f.line for f in found] == lines


@pytest.mark.parametrize("rule,src,lines", [KFRM006, KFRM007, KFRM008],
                         ids=lambda v: v if isinstance(v, str) and
                         v.startswith("KFRM") else None)
def test_rule_honours_disable_comments(rule, src, lines):
    text = textwrap.dedent(src).splitlines()
    for n in lines:
        text[n - 1] += f"  # kfrm: disable={rule.lower()} reason given"
    assert tlint.lint_source("\n".join(text), "fixture.py") == []
    whole = f"# kfrm: disable-file={rule}\n" + textwrap.dedent(src)
    assert tlint.lint_source(whole, "fixture.py") == []
    # another rule's disable does not silence this one
    other = textwrap.dedent(src).splitlines()
    other[lines[0] - 1] += "  # kfrm: disable=KFRM001"
    assert len(tlint.lint_source("\n".join(other), "fixture.py")) == \
        len(lines)


def test_quiet_idioms():
    """What each rule leaves alone: a sync outside a region or under a
    sanctioned site, a nested function's body (it runs later), an
    in-place accumulation, a call that takes the old state, arithmetic
    on its scalar attributes, and construction outside loops."""
    src = """\
    from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync

    def fine(step, state, grads, gs, cache, n):
        for _ in range(n):
            with hostsync.region("train.step"):
                with hostsync.sanctioned("train.offload_stream"):
                    ok = bool(step(state).isfinite().all())
                def later(t):
                    return t.item()
                n_left = float(n)
            state = step(state)
            cache = rewind(cache, cache.offset - 1)
            for k, t in grads.items():
                t.add_(gs[k])
            total = total + grads["w"]
        with hostsync.region("x"):
            v = state.item()                 # a region, but no loop
        return state
    """
    assert _lint(src) == []


def test_syntax_error_is_a_finding():
    found = tlint.lint_source("def broken(:\n", "bad.py")
    assert [f.rule for f in found] == ["KFRM000"]


def test_port_tree_lints_clean():
    found = tlint.lint_paths([str(ROOT / "kubeflow_rm_tpu_torch"),
                              str(ROOT / "chip_smoke.py")])
    assert found == [], "\n".join(f.render() for f in found)
    assert tlint.ALLOWLIST == {
        "KFRM001": ("kubeflow_rm_tpu_torch/analysis/lockgraph.py",)}


@pytest.mark.parametrize("name", ["kfrm006_scalar_sync_in_loop.py",
                                  "kfrm007_jit_in_loop.py",
                                  "kfrm008_nondonated_state.py"])
def test_jax_fixtures_are_jax_idioms(name):
    """JAX's rules find their fixtures; the port's find nothing there
    (a ``jax.jit`` site is no torch hot region, capture or rebuild)."""
    path = str(FIXTURES / name)
    rule = name[:7].upper()
    assert {f.rule for f in jlint.lint_paths([path])} == {rule}
    assert tlint.lint_paths([path]) == []


def test_rule_table_is_the_gate():
    assert {c.rule_id for c in tlint.ALL_RULES} == set(gate.TORCHCHECK_RULES)
    assert gate.TORCHCHECK_RULES == {f"KFRM00{i}" for i in range(1, 9)}


def test_gate_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text(textwrap.dedent(KFRM008[1]))
    assert gate.main([str(clean), "--no-selfcheck"]) == 0
    assert gate.main([str(dirty), "--no-selfcheck"]) == 1
    assert "KFRM008" in capsys.readouterr().out
    assert gate.main([str(dirty), "--no-selfcheck", "--json"]) == 1
    assert '"rule": "KFRM008"' in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        gate.main(["--no-such-flag"])
    assert e.value.code == 2
    # the lint CLI's own contract
    assert lint_cli.main([str(clean)]) == 0
    assert lint_cli.main([str(dirty)]) == 1
    assert lint_cli.main([str(dirty), "--rules", "KFRM006"]) == 0
    assert lint_cli.main([str(clean), "--rules", "KFRM009"]) == 2
    assert lint_cli.main(["--list-rules"]) == 0
    assert "KFRM007" in capsys.readouterr().out


def test_gate_runs_lint_and_selfcheck_on_the_shipped_tree():
    r = subprocess.run([sys.executable, "-m",
                        "kubeflow_rm_tpu_torch.analysis.lint"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    r = subprocess.run([sys.executable, "-m",
                        "kubeflow_rm_tpu_torch.analysis.torchcheck",
                        "--json"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert '"findings": []' in r.stdout
    assert '"selfcheck_failures": []' in r.stdout
