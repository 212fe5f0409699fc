"""What the benchmark's modules import, read from their sources: nothing
of JAX or the JAX package (top-level names compared whole: the port's
name begins with the JAX package's), nothing of the port in the
reference, and the port only in `system.py` and the tests."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.harness import BENCH, ROOT
from bench_port.run import FORBIDDEN, forbidden_modules

PORT = "pose2mesh_release_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]
        elif isinstance(node, ast.Name) and node.id == "PORT":
            yield PORT


def _sources():
    return sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert PORT not in names
    assert "bench_port" not in names  # relative imports stay inside reference/
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, f"{path.name} reaches out of reference/"


def test_only_system_imports_the_port():
    users = {p.relative_to(BENCH).as_posix() for p in _sources()
             if PORT in set(_imports(p)) and "tests/" not in p.relative_to(BENCH).as_posix()}
    assert users == {"system.py"}


def test_forbidden_names_compare_whole():
    assert "pose2mesh_release_tpu" in FORBIDDEN
    import pose2mesh_release_tpu_torch  # noqa: F401
    assert "pose2mesh_release_tpu" not in forbidden_modules()


def test_run_loads_no_jax_module():
    code = ("import sys; import bench_port.run, bench_port.harness, bench_port.system, "
            "bench_port.calibrate; import pose2mesh_release_tpu_torch.deploy, "
            "pose2mesh_release_tpu_torch.train_setup; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'pose2mesh_release_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
