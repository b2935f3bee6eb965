"""The port's bitwise-batchability lint, on the CPU: the torch forms of the
six cases of ``tests/test_determinism_lint.py`` (a vmapped matmul is
flagged, a loop over lanes passes, a cross-lane sum is flagged, a per-lane
sum passes, a matmul inside a vmapped loop is flagged, a vmapped elementwise
loop passes), every shipped port app linting clean (montecarlo's kernel
included), and the ``python -m repro_torch.analysis.lint`` CLI."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import LintFinding, lint_app, lint_batched_fn
from repro_torch.analysis.lint import run_determinism_lint
from repro_torch.hpc.suite import app_names, get_app

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
A = torch.from_numpy(np.arange(16, dtype=np.float32).reshape(4, 4) / 16.0)
U = torch.ones((3, 4))
PRODUCTS = {"mm", "mv", "bmm", "matmul", "addmm", "dot"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_vmapped_matmul_flagged():
    """vmap turns the per-lane matvec into one batched GEMM."""
    findings = lint_batched_fn("bad/vmap_matmul", torch.vmap(lambda u: A @ u), (U,), {0: 0})
    assert findings, "vmapped matmul must be flagged"
    assert any(f.primitive in PRODUCTS for f in findings)
    assert all(isinstance(f, LintFinding) for f in findings)


def test_loop_over_lanes_matmul_passes():
    """A Python loop over lanes (lax.map's form) runs the serial matvec once
    per lane: bitwise-safe."""
    findings = lint_batched_fn(
        "good/map_matmul", lambda ub: torch.stack([A @ u for u in ub]), (U,), {0: 0})
    assert findings == []


def test_cross_lane_reduction_flagged():
    findings = lint_batched_fn("bad/cross_lane_sum", lambda ub: ub.sum(dim=0), (U,), {0: 0})
    assert any(f.primitive == "sum" and "lane axis" in f.reason for f in findings)


def test_per_lane_reduction_passes():
    findings = lint_batched_fn("good/per_lane_sum", lambda ub: ub.sum(dim=1), (U,), {0: 0})
    assert findings == []


def test_matmul_inside_vmapped_loop_flagged():
    """A vmapped loop unrolls into the graph: a matmul in its body is caught."""
    def body(u):
        x = u
        for _ in range(3):
            x = torch.tanh(A @ x)
        return x

    findings = lint_batched_fn("bad/vmap_loop_matmul", torch.vmap(body), (U,), {0: 0})
    assert any(f.primitive in PRODUCTS for f in findings)


def test_vmapped_elementwise_loop_passes():
    """Lane-carrying loop-invariant operands are fine as long as the body
    stays elementwise per lane."""
    b = torch.full((3, 4), 0.5)

    def body(u, bb):
        x = u
        for _ in range(3):
            x = torch.tanh(x) + bb
        return x

    findings = lint_batched_fn("good/vmap_loop_elementwise", torch.vmap(body), (U, b),
                               {0: 0, 1: 0})
    assert findings == []


@pytest.mark.parametrize("fn, prim", [
    (lambda ub: torch.stack([ub[0] + ub[1], ub[1], ub[2]]), "add"),
    (lambda ub: ub.reshape(4, 3), "view"),
    (lambda ub: ub.cumsum(dim=0), "cumsum"),
    (lambda ub: torch.bmm(ub[:, None, :], ub[:, :, None]), "bmm"),
    (lambda ub: ub[0] + ub, "add"),
])
def test_lane_mixing_forms_flagged(fn, prim):
    """Two lanes in one value, a reshape across lanes, a scan along lanes,
    a batched product, one lane against the stack: each is a finding."""
    findings = lint_batched_fn("bad/mix", fn, (U,), {0: 0})
    assert any(f.primitive == prim for f in findings), findings


def test_all_shipped_batched_apps_pass():
    """Every supports_batched_step app declares kernels and lints clean."""
    checked = 0
    names = set()
    for name in app_names():
        app = get_app(name, device="cpu")
        if not app.supports_batched_step:
            continue
        kernels = app.batched_kernels()
        assert kernels, f"{name}: supports_batched_step but no batched_kernels()"
        for kname, findings in lint_app(app).items():
            assert findings == [], f"{name}/{kname}: {findings}"
            checked += 1
            names.add(name)
    assert checked >= 5
    assert {"montecarlo", "sor", "heat", "cg", "pagerank", "kmeans", "mg"} <= names


def test_montecarlo_batched_kernel_is_the_serial_round():
    """Each lane of mc_rounds is the serial round bit for bit, and its
    tallies are the JAX package's _mc_rounds tallies."""
    from repro.hpc.montecarlo import _mc_rounds as jax_mc_rounds
    from repro_torch.hpc.montecarlo import _mc_rounds, _round

    ks = [0, 5, 9]
    tal, scratch = _mc_rounds(torch.tensor(ks), 1024, 10, "cpu")
    for i, k in enumerate(ks):
        t, s = _round(k, 1024, 10, "cpu")
        assert torch.equal(tal[i], t) and torch.equal(scratch[i], s)
    jtal, _ = jax_mc_rounds(np.asarray(ks, np.int32), np.float32(1.0), 1024, 10)
    np.testing.assert_array_equal(tal.numpy(), np.asarray(jtal).astype(np.int64))


def test_cli_passes_on_shipped_apps(capsys):
    assert run_determinism_lint(device="cpu") == 0
    out = capsys.readouterr().out
    assert "kernels checked, 0 findings" in out
    assert "ok   montecarlo/mc_rounds" in out


def test_cli_flags_missing_kernels():
    class FakeApp:
        name = "fake"
        supports_batched_step = True

        @staticmethod
        def batched_kernels():
            return ()

    with pytest.MonkeyPatch.context() as mp:
        import repro_torch.hpc.suite as suite
        mp.setattr(suite, "get_app", lambda name, **kw: FakeApp())
        assert run_determinism_lint(["fake"], device="cpu") == 1


def test_cli_module_exits_zero_without_jax():
    """``python -m repro_torch.analysis.lint --device cpu`` in a fresh
    interpreter: exit 0, every app's kernels clean, jax never loaded."""
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "sys.argv = ['lint', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis.lint', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print('RC', rc, 'LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RC 0 LOADED []" in out.stdout, out.stdout
    assert "kernels checked, 0 findings" in out.stdout
