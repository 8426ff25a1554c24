"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import benchtiny
from benchmark import harness

BENCH = os.path.join(benchtiny.ROOT, "benchmark")


def _modules(path):
    """The full names of the modules ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _imports(path):
    return (name.split(".")[0] for name in _modules(path))


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(["ital_tpu_torch", "ital_tpu_torch.serve", "numpy"]) == []
    assert harness.forbidden_modules(["ital_tpu.ops", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "ital_tpu", "jax", "jaxlib"]


def test_no_source_imports_jax_or_the_jax_package():
    files = [path for folder in ("", "metrics", "references", "traffic")
             for path in glob.glob(os.path.join(BENCH, folder, "*.py"))]
    for path in files:
        assert not harness.forbidden_modules(list(_imports(path))), path


def test_reference_imports_nothing_of_the_port():
    plain = {"__future__", "collections", "itertools", "json", "math", "os", "typing",
             "dataclasses", "numpy", "torch"}
    for name in ("reference.py", "corpus.py", "generator.py", "roofline.py"):
        assert set(_imports(os.path.join(BENCH, name))) <= plain, name
    for path in glob.glob(os.path.join(BENCH, "references", "*.py")):
        names = set(_modules(path)) - {"benchmark.reference"}
        assert {n.split(".")[0] for n in names} <= plain, path


def test_the_run_loads_neither_and_refuses_where_loaded(tmp_path):
    root = benchtiny.tiny_copy(str(tmp_path))
    probe = ("import sys, runpy; sys.argv = ['run.py', '--workload', 'tiny.single', '--seed', "
             "'3', '--seconds', '1', '--trace', '0', '--device', 'cpu']\n"
             "try:\n    runpy.run_path('benchmark/run.py', run_name='__main__')\n"
             "except SystemExit as e:\n    code = e.code\n"
             "bad = sorted({m.split('.')[0] for m in sys.modules} & "
             "{'jax', 'jaxlib', 'flax', 'ital_tpu'})\nprint('LOADED', bad, code)")
    p = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert "LOADED [] 0" in p.stdout, p.stderr[-2000:]
    fake = ("import sys, types, runpy; sys.modules['jax'] = types.ModuleType('jax'); "
            "sys.argv = ['run.py', '--workload', 'tiny.single', '--seed', '3', '--seconds', '1', "
            "'--trace', '0', '--device', 'cpu']; runpy.run_path('benchmark/run.py', "
            "run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", fake], cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode != 0 and "jax" in p.stderr and p.stdout.strip() == ""
