"""No module of the benchmark imports jax or the JAX package, and the
reference imports nothing of the port (top-level names compared whole:
the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys

import pytest

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "pycricodecs_tpu"}


def top_imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def modules():
    return sorted(p for p in run.HERE.rglob("*.py")
                  if "tests" not in p.relative_to(run.HERE).parts)


@pytest.mark.parametrize("path", modules(), ids=lambda p: p.name)
def test_no_jax(path):
    assert not top_imports(path) & FORBIDDEN


def test_reference_is_plain():
    allowed = {"__future__", "math", "numpy", "torch"}
    assert top_imports(run.HERE / "reference.py") <= allowed


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from portbench import run; "
            "from portbench.tests.conftest import tiny_config, with_waiting; "
            "b = with_waiting(run.load_json('BENCHMARK.json')); "
            f"c = tiny_config({str(tmp_path)!r}); "
            "run.run_cell(b, 'adx_bank_cpk.extract', 3, 0.2, False, 'cpu', "
            "config=c); print(run.forbidden_modules(), "
            "'pycricodecs_tpu_torch' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.CHECKOUT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import portbench.reference as r; "
            "r.compress_plain([bytes(range(256)) * 3]); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'pycricodecs_tpu', 'pycricodecs_tpu_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.CHECKOUT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
