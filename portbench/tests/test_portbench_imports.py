"""What the benchmark imports: nothing of JAX or the JAX package
anywhere under ``portbench/`` (compared by whole top-level name: the
port's ``kubeflow_rm_tpu_torch`` begins with the JAX package's name),
and nothing of the program in the plain reference."""

import ast

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "kubeflow_rm_tpu"}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = list((ROOT / "portbench").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not FORBIDDEN & set(imports(f)), f


def test_the_reference_imports_nothing_of_the_program():
    ref = ROOT / "portbench" / "reference"
    for f in ref.rglob("*.py"):
        names = set(imports(f))
        assert "kubeflow_rm_tpu_torch" not in names, f
        assert names <= {"__future__", "math", "torch", "portbench"}, f
    # and what it imports of the benchmark imports nothing of the program
    for f in (ROOT / "portbench" / "arch.py",):
        assert "kubeflow_rm_tpu_torch" not in set(imports(f))
