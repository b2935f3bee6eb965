"""The port's lane driver (``repro_torch.core.lane_driver``) on the CPU.

Torch ports of the JAX package's lane-driver tests in
``tests/test_campaign_vec.py``: for every app with a driver, advance_lanes
equals the serial phase-A loop bit for bit (mg included: the port's batched
V-cycle rounds as its serial one), and a NaN-poisoned lane comes back
unmodified with ok=False.  The host parts copied from the JAX package
(``f32_monotone_cutoff``, ``_plan_buckets``) agree with it, and a CI
campaign of each app goes through the driver without falling back.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import lane_driver as jax_lane_driver
from repro_torch.core import CrashTester, PersistPlan
from repro_torch.core import lane_driver
from repro_torch.hpc.suite import ci_app, default_cache

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

#: the JAX package's sub-CI sizes for the lane-driver tests
TINY_SIZES = {
    "cg": dict(grid=12, n_iters=60),
    "mg": dict(grid=16, n_iters=8),
    "kmeans": dict(n_points=200, n_iters=6),
    "montecarlo": dict(batch=256, n_iters=8),
    "heat": dict(grid=16, n_iters=60),
    "pagerank": dict(n_nodes=96, n_iters=60),
}
#: the field advance_lanes carries that a perturbation meaningfully reaches
DRIVER_NOISE_FIELD = {
    "cg": "x", "mg": "u", "kmeans": "centroids",
    "montecarlo": "sums", "heat": "u", "pagerank": "rank",
}
#: poisoning this field reaches the convergence decision within one step,
#: so the serial loop raises FloatingPointError (cg decides on the carried
#: rho = r·r, not on x)
POISON_FIELD = {"heat": "u", "cg": "r", "mg": "u", "pagerank": "rank"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tiny_app(name):
    return ci_app(name, device="cpu", **TINY_SIZES[name])


def _serial_advance(app, s0, it, stop):
    """The campaign's phase-A loop: step, then converged(), to the budget."""
    s = {k: np.array(v, copy=True) for k, v in s0.items()}
    while it < stop:
        s = app.run_iteration(s)
        it += 1
        try:
            if app.converged(s, it):
                break
        except FloatingPointError:
            return s, it, False
    return s, it, True


def _assert_bitwise(name, i, want, got):
    assert set(got) == set(want), (name, i)
    for f in want:
        a, b = np.asarray(want[f]), np.asarray(got[f])
        assert a.dtype == b.dtype and a.shape == b.shape, (name, i, f)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (
            f"{name} lane {i}: field {f!r} not bitwise the serial value")


@pytest.mark.parametrize("name", sorted(TINY_SIZES))
def test_lane_driver_matches_serial_bitwise(name):
    """advance_lanes == the serial phase-A loop, full state bitwise, for
    lanes entering at scattered iterations (including at and near the
    stop bound) with small per-lane perturbations."""
    app = _tiny_app(name)
    noise_field = DRIVER_NOISE_FIELD[name]
    s = app.init(0)
    traj = [s]
    golden_iters = app.n_iters
    it = 0
    while it < app.n_iters:
        s = app.run_iteration(s)
        it += 1
        traj.append(s)
        if app.converged(s, it):
            golden_iters = it
            break
    rng = np.random.default_rng(7)
    entry_its = sorted({1, golden_iters // 2, max(golden_iters - 1, 1), golden_iters})
    lanes = []
    for ei in entry_its:
        lane = {k: np.array(v, copy=True) for k, v in traj[ei].items()}
        lane[noise_field] = (
            lane[noise_field] + rng.standard_normal(lane[noise_field].shape) * 1e-5
        ).astype(lane[noise_field].dtype)
        lanes.append((lane, ei))
    serial = [_serial_advance(app, s0, ei, golden_iters) for s0, ei in lanes]
    states, its, oks = app.advance_lanes(
        [s0 for s0, _ in lanes], [ei for _, ei in lanes], golden_iters
    )
    for i, ((ss, sit, sok), ds, dit, ok) in enumerate(zip(serial, states, its, oks)):
        if not sok:
            assert not ok, f"{name} lane {i}: driver missed a raising lane"
            continue
        assert bool(ok), f"{name} lane {i}: driver flagged a clean lane"
        assert int(dit) == sit, f"{name} lane {i}: stopped at {dit} != {sit}"
        _assert_bitwise(name, i, ss, ds)


@pytest.mark.parametrize("name", ["heat", "cg", "mg", "pagerank"])
def test_lane_driver_flags_nan_lanes(name):
    """A NaN-poisoned lane (where serial converged() raises) must come back
    ok=False and untouched, while its healthy neighbours advance normally."""
    app = _tiny_app(name)
    clean = app.run_iteration(app.init(0))
    poisoned = {k: np.array(v, copy=True) for k, v in clean.items()}
    poisoned[POISON_FIELD[name]] = np.full_like(poisoned[POISON_FIELD[name]], np.nan)
    stop = min(app.n_iters, 6)
    states, its, oks = app.advance_lanes([clean, poisoned], [1, 1], stop)
    assert bool(oks[0]) and not bool(oks[1])
    assert states[1] is poisoned and its[1] == 1
    want, wit, wok = _serial_advance(app, clean, 1, stop)
    assert wok and int(its[0]) == wit
    _assert_bitwise(name, 0, want, states[0])


@pytest.mark.parametrize("name", ["heat", "mg"])
def test_lane_driver_chunk_length_changes_nothing(name, monkeypatch):
    """A bucket runs whole chunks: a lane that stops mid-chunk is frozen by
    the mask, so any chunk length gives the same bits and stop iterations."""
    app = _tiny_app(name)
    lanes = [app.init(0)]
    for _ in range(4):
        lanes.append(app.run_iteration(lanes[-1]))
    its = list(range(len(lanes)))
    stop = app.n_iters
    got = []
    for chunk in (1, 3, 8):
        monkeypatch.setattr(lane_driver, "CHUNK", chunk)
        monkeypatch.setattr(lane_driver, "_DRIVER_CACHE", {})
        states, out_its, oks = app.advance_lanes(lanes, its, stop)
        got.append((out_its, oks, [s["u"].tobytes() for s in states]))
    assert got[0] == got[1] == got[2]
    assert got[0][0] == [_serial_advance(app, s, it, stop)[1] for s, it in zip(lanes, its)]
    assert all(got[0][1])


@pytest.mark.parametrize("seed", range(4))
def test_plan_buckets_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 40))
        rem = sorted((int(v) for v in rng.integers(1, 400, n)), reverse=True)
        assert lane_driver._plan_buckets(rem) == jax_lane_driver._plan_buckets(rem)
        assert sum(lane_driver._plan_buckets(rem)) == n


@pytest.mark.parametrize("tol", [1e-8, 1e-4, 0.1])
def test_f32_monotone_cutoff_equals_jax(tol):
    pred = lambda x: x < tol * 0.5  # noqa: E731 - the serial decision shape
    got = lane_driver.f32_monotone_cutoff(pred)
    assert got.tobytes() == jax_lane_driver.f32_monotone_cutoff(pred).tobytes()


if HAVE_HYPOTHESIS:

    @given(
        tol=st.floats(1e-8, 1e-1, allow_nan=False, allow_infinity=False),
        raw=st.integers(0, 2**31 - 1),
    )
    @settings(max_examples=300, deadline=None)
    def test_f32_monotone_cutoff_property(tol, raw):
        """For every finite non-negative f32 value v, ``v <= cutoff`` equals
        the host predicate ``pred(float(v))`` — otherwise a device
        convergence decision could diverge from the serial loop by one
        iteration and break bit-for-bit equality."""
        v = np.int32(raw).view(np.float32)
        if not np.isfinite(v) or v < 0:
            return
        pred = lambda x: x < tol * 0.5  # noqa: E731 - the serial decision shape
        cutoff = lane_driver.f32_monotone_cutoff(pred)
        assert bool(v <= cutoff) == bool(pred(float(v)))


@pytest.mark.parametrize("name", sorted(TINY_SIZES))
def test_ci_campaign_goes_through_the_driver(name):
    """A CI campaign takes phase A through advance_lanes and never falls
    back to the host loop ("advance_lanes raised" is a RuntimeWarning)."""
    app = ci_app(name, device="cpu")
    calls = []
    advance = app.advance_lanes

    def counted(states, its, stop):
        calls.append(len(states))
        return advance(states, its, stop)

    app.advance_lanes = counted
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*advance_lanes raised", category=RuntimeWarning)
        camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=123,
                           engine="vec").run_campaign(4)
    assert len(camp.records) == 4
    assert calls and sum(calls) > 0
