"""The port's locking lint rules, KFRM001-005
(``kubeflow_rm_tpu_torch/analysis/lint/rules.py``), against JAX's.

Each rule fires on an inline fixture and honours ``# kfrm: disable=``;
JAX's own fixtures (``tests/lint_fixtures/kfrm00[1-5]_*.py``, the clean
and the disabled one) give the same findings under the port's rules as
under JAX's, since these rules are plain Python; the lock factory's file
is the allowlist's one entry and needs it for nothing (each raw
primitive there carries its own disable comment).
"""

import ast
import textwrap
from pathlib import Path

import pytest

from kubeflow_rm_tpu.analysis import lint as jlint
from kubeflow_rm_tpu_torch.analysis import lint as tlint
from kubeflow_rm_tpu_torch.analysis.lint import rules as trules

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "lint_fixtures"
LOCK_RULES = ("KFRM001", "KFRM002", "KFRM003", "KFRM004", "KFRM005")


def _lint(src: str):
    return tlint.lint_source(textwrap.dedent(src), "fixture.py")


# (rule, source, flagged lines)
INLINE = [
    ("KFRM001", """\
        import threading
        from threading import RLock

        GUARD = threading.Lock()
        COND = threading.Condition()

        def make():
            return RLock()
        """, [4, 5, 8]),
    ("KFRM002", """\
        import subprocess
        import time

        def poll(self):
            with self._lock:
                time.sleep(0.1)
                subprocess.run(["true"])
                self.sock.sendall(b"x")
                fut.result()
            time.sleep(0.1)                  # outside: fine
        """, [6, 7, 8, 9]),
    ("KFRM003", """\
        def commit(a_lock, b_lock):
            a_lock.acquire()
            b_lock.acquire()
            try:
                pass
            finally:
                b_lock.release()
        """, [2]),
    ("KFRM004", """\
        def reconcile(self, api, obj):
            with self._lock:
                api.create(obj)
                self.api.record_event(obj, "x")
                self.update(obj)             # self: not a client
            api.patch(obj)                   # outside: fine
        """, [3, 4]),
    ("KFRM005", """\
        def best_effort(f, log):
            try:
                f()
            except Exception:
                pass
            try:
                f()
            except BaseException:
                return None
            try:
                f()
            except Exception as e:
                keep = e                     # the error flows on: fine
            try:
                f()
            except Exception:
                log.warning("f failed")      # logged: fine
        """, [4, 8]),
]


@pytest.mark.parametrize("rule,src,lines", INLINE,
                         ids=[r for r, _, _ in INLINE])
def test_rule_fires_on_its_inline_fixture(rule, src, lines):
    found = _lint(src)
    assert {f.rule for f in found} == {rule}, found
    assert [f.line for f in found] == lines
    assert [f.as_dict() for f in found] == [
        f.as_dict() for f in jlint.lint_source(textwrap.dedent(src),
                                               "fixture.py")]


@pytest.mark.parametrize("rule,src,lines", INLINE,
                         ids=[r for r, _, _ in INLINE])
def test_rule_honours_disable_comments(rule, src, lines):
    text = textwrap.dedent(src).splitlines()
    for n in lines:
        text[n - 1] += f"  # kfrm: disable={rule} (a reason)"
    assert tlint.lint_source("\n".join(text) + "\n", "fixture.py") == []
    wide = f"# kfrm: disable-file={rule}\n" + textwrap.dedent(src)
    assert tlint.lint_source(wide, "fixture.py") == []


def _fixtures():
    return sorted(p.name for p in FIXTURES.glob("*.py")
                  if p.name[:7].upper() in LOCK_RULES
                  or p.name in ("clean.py", "disabled.py"))


@pytest.mark.parametrize("name", _fixtures())
def test_jax_fixtures_give_the_same_findings(name):
    """The locking rules are plain Python: JAX's fixtures give the same
    findings (rule, line, column, message) under the port's rules."""
    path = FIXTURES / name
    src = path.read_text()
    want = [f.as_dict() for f in jlint.lint_source(src, str(path))
            if f.rule in LOCK_RULES]
    got = [f.as_dict() for f in tlint.lint_source(src, str(path))
           if f.rule in LOCK_RULES]
    assert got == want
    if name.startswith("kfrm"):
        assert {f["rule"] for f in got} == {name[:7].upper()}


def test_the_lock_factory_is_allowlisted_and_clean_without_it():
    path = ROOT / "kubeflow_rm_tpu_torch" / "analysis" / "lockgraph.py"
    assert any(str(path).endswith(s)
               for s in tlint.ALLOWLIST["KFRM001"])
    # the allowlist is belt and braces: every raw primitive there has
    # its own inline reason
    tree = ast.parse(path.read_text())
    found = [f for cls in trules.ALL_RULES
             for f in cls(str(path)).run(tree)]
    kept = tlint.lint_source(path.read_text(), "lockgraph_copy.py")
    assert {f.rule for f in found} <= {"KFRM001"} and kept == []
    # a raw lock anywhere else is a finding
    assert [f.rule for f in tlint.lint_source(
        "import threading\nL = threading.Lock()\n",
        "kubeflow_rm_tpu_torch/x.py")] == ["KFRM001"]


def test_an_aliased_primitive_is_named_by_what_it_is():
    """JAX's KFRM001 raises KeyError on ``from threading import RLock as
    R`` (it looks the factory up by the alias); the port's flags it and
    names the factory."""
    src = "from threading import RLock as R\nL = R()\n"
    with pytest.raises(KeyError):
        jlint.lint_source(src, "fixture.py")
    [found] = tlint.lint_source(src, "fixture.py")
    assert found.rule == "KFRM001" and "make_rlock" in found.message


def test_rule_order_and_synopses_are_jaxs():
    port = {c.rule_id: c.synopsis for c in tlint.ALL_RULES}
    jax = {c.rule_id: c.synopsis for c in jlint.ALL_RULES}
    for rule in LOCK_RULES:
        assert port[rule] == jax[rule]
    assert [c.rule_id for c in tlint.ALL_RULES] == \
        [f"KFRM00{i}" for i in range(1, 9)]
