"""What a run loads: never `jax`, `jaxlib`, `flax` or `siftgpu_tpu`,
compared by whole top-level names (the port's name begins with the JAX
package's), and a reference that imports nothing of the program."""

import ast
import os
import subprocess
import sys
import types

from benchmark.lib import runner
from benchmark.tests.sizes import ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "dataclasses", "math", "typing", "numpy", "torch"}
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        assert _imports(path) <= allowed, path.name


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in sorted((ROOT / "benchmark").rglob("*.py")):
        assert not _imports(path) & set(runner.FORBIDDEN), path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "siftgpu_tpu_torch_like", types.ModuleType("x"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "siftgpu_tpu.ops", types.ModuleType("siftgpu_tpu.ops"))
    assert runner.forbidden_modules() == ["siftgpu_tpu"]


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.tests.sizes import SMALL; from benchmark.lib import runner;"
            "runner.run_cell('vga-frame', 7, 0.3, False, 'cpu', sizes=SMALL['vga-frame'],"
            " settle=0);"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "siftgpu_tpu_torch" in loaded
    assert not loaded & set(runner.FORBIDDEN)
