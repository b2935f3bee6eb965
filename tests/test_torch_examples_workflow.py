"""The port's examples of the characterization workflow (quickstart,
workflow_orchestrate, system_efficiency), each run on the CPU in a fresh
interpreter that never loads jax, against the JAX example of the same name
at the same arguments: the same report, line for line, but for the paths
of the artifacts each writes and the Spearman scores' values (cg's
campaigns agree in outcome classes, not in every inconsistency rate; the
objects each selects must agree)."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
EXAMPLES = os.path.join(ROOT, "examples")

#: a port example run in a fresh interpreter, which then reports the jax and
#: JAX-package modules loaded
_RUN = (
    "import runpy, sys\n"
    "sys.argv = [PATH] + ARGS\n"
    "try:\n"
    "    runpy.run_path(PATH, run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', 'repro')\n"
    "                 or m.startswith(('jax.', 'jaxlib', 'ml_dtypes.', 'repro.')))\n"
    "    print('LOADED', bad)\n"
)


def run_port_example(name, args, tmp_path, timeout=600):
    """stdout of examples/torch_<name>.py on the CPU (TMPDIR in tmp_path);
    fails if it exits nonzero or loads jax or the JAX package."""
    os.makedirs(tmp_path, exist_ok=True)
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    code = f"PATH = {path!r}\nARGS = {list(args) + ['--device', 'cpu']!r}\n" + _RUN
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("LOADED []"), out.stdout[-2000:]
    return out.stdout


def run_jax_example(name, args, tmp_path, timeout=600):
    os.makedirs(tmp_path, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES, f"{name}.py"), *args],
                         capture_output=True, text=True, env=env, cwd=str(tmp_path),
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _report(stdout, tmp_path):
    """The report's lines, artifact paths and Spearman values blanked."""
    lines = [l for l in stdout.splitlines() if l and not l.startswith("LOADED ")]
    lines = [re.sub(r"Rs=\S+ p=\S+", "Rs=<rs>", l) for l in lines]
    return [re.sub(re.escape(str(tmp_path)) + r"\S*", "<path>", l) for l in lines]


@pytest.mark.parametrize("name, args", [
    ("quickstart", []),
    ("workflow_orchestrate", ["--tests", "8"]),
    ("system_efficiency", ["--tests", "8", "--failures", "200"]),
])
def test_port_example_reports_the_jax_examples_plan(name, args, tmp_path):
    port = _report(run_port_example(name, args, tmp_path / "port"), tmp_path / "port")
    ref = _report(run_jax_example(name, args, tmp_path / "jax"), tmp_path / "jax")
    plan = [l for l in ref if "plan" in l or "rates:" in l]
    assert plan, ref
    assert port == ref
