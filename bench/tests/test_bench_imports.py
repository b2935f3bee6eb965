"""No file of the benchmark imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is allowed, ``repro`` is not), the plain
references import nothing of the port, and a run refuses without a card."""
import ast
import os
import subprocess
import sys

import pytest
from _tiny import ROOT, harness

BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted((ROOT / "bench").rglob("*.py"))


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not set(_imported(path)) & BANNED


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imported(path))
    assert names <= {"__future__", "typing", "torch", "numpy"}, names
    tree = ast.parse(path.read_text())
    assert not any(isinstance(n, ast.ImportFrom) and n.level > 0 for n in ast.walk(tree))


def test_nothing_reads_the_jax_benchmarks():
    for path in FILES:
        if path.parent.name != "tests":
            assert "benchmarks" not in path.read_text(), path


def test_banned_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in harness.banned_modules() or "repro" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.banned_modules()


def test_a_tiny_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from _tiny import run_tiny\n"
            "from bench import harness\n"
            "out = run_tiny('heat-32768-noflush', 0.3)\n"
            "assert out['correct'], out['checks']\n"
            "print(harness.banned_modules())\n") % (str(ROOT / "bench" / "tests"), str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                          "heat-32768-noflush", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert res.returncode != 0 and res.stdout == ""
