"""The port's serving path against the JAX package's, on the CPU.

* The ``decode`` registry app reproduces its pinned golden
  (``tests/golden/campaign_goldens.json``) and the JAX plan.
* ``repro_torch.launch.serve`` at the JAX CLI's reduced defaults, given
  JAX's weights and prompts, decodes JAX's token stream, both uninterrupted
  and after a crash at step 32 and a resume from the arena: exactly in
  float32; in the CLI's bfloat16 up to rare near ties (see _check_stream).
* bfloat16 tensor leaves flush, delta-flush and restore byte for byte.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.arena import NVMArena as JaxNVMArena
from repro.core.workflow import WorkflowConfig as JaxWorkflowConfig
from repro.core.workflow import run_workflow as jax_run_workflow
from repro.hpc.suite import ci_app as jax_ci_app
from repro.hpc.suite import default_cache as jax_default_cache
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init_params
from repro.models import scaled_down as jax_scaled_down
from repro_torch.convert import host_array, params_from_jax, state_to_numpy, state_to_torch
from repro_torch.core import CrashTester, PersistPlan
from repro_torch.core.arena import NVMArena
from repro_torch.core.manager import EasyCrashManager, FlushPolicy
from repro_torch.core.workflow import WorkflowConfig, run_workflow
from repro_torch.hpc.suite import ci_app, default_cache
from repro_torch.launch import serve

GOLDENS = os.path.join(os.path.dirname(__file__), "golden", "campaign_goldens.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------ decode app
def test_decode_app_reproduces_golden():
    with open(GOLDENS) as f:
        goldens = json.load(f)
    cfg = goldens["config"]
    app = ci_app("decode", device="cpu")
    camp = CrashTester(app, PersistPlan.none(), default_cache(app),
                       seed=cfg["seed"]).run_campaign(cfg["n_tests"])
    counts = {c: 0 for c in ("S1", "S2", "S3", "S4")}
    for r in camp.records:
        counts[r.outcome] += 1
    got = {"counts": counts, "golden_iters": camp.golden_iters,
           "crash_iters": [r.iter_idx for r in camp.records]}
    assert got == goldens["apps"]["decode"]


def test_decode_app_plan_equals_jax():
    jax_app = jax_ci_app("decode")
    want = jax_run_workflow(jax_app, JaxWorkflowConfig(
        n_tests=24, cache=jax_default_cache(jax_app), seed=0)).plan
    app = ci_app("decode", device="cpu")
    got = run_workflow(app, WorkflowConfig(n_tests=24, cache=default_cache(app), seed=0)).plan
    assert (got.objects, got.region_freq) == (want.objects, want.region_freq)
    assert got.objects == ("tokens",)


def test_decode_app_with_jax_weights_decodes_jax_golden_stream():
    """Given the JAX app's weights and prompts, the port's app runs the
    same 12 greedy iterations to the same token buffer."""
    jax_app = jax_ci_app("decode")
    app = ci_app("decode", device="cpu")
    app._params = params_from_jax(jax.tree.map(np.asarray, jax_app._params), "cpu")
    prompts = jax_app.init(0)["tokens"][:, :app.prompt_len]
    app._prompts = torch.from_numpy(np.array(prompts))
    s0, t0 = app.init(0), jax_app.init(0)
    assert np.array_equal(s0["tokens"], t0["tokens"])
    assert s0["cache"].tobytes() == np.asarray(t0["cache"]).tobytes()
    np.testing.assert_array_equal(app._golden(), jax_app._golden())


# ---------------------------------------------------------------- server
def _f32(get_arch):
    return lambda name: dataclasses.replace(get_arch(name), dtype="float32")


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    """The model's dtype for both servers: the CLI's bfloat16, or float32
    (both packages' get_arch patched)."""
    if request.param == "float32":
        monkeypatch.setattr(jax_serve, "get_arch", _f32(jax_get_arch))
        monkeypatch.setattr(serve, "get_arch", _f32(serve.get_arch))
    return request.param


def _jax_stream(workdir):
    jax_serve.main(["--workdir", str(workdir)])
    return JaxNVMArena.reattach(os.path.join(str(workdir), "serve_arena")).get("tokens")


def _jax_weights_and_prompts(dtype):
    args = serve.parser().parse_args(["--device", "cpu"])
    cfg = jax_scaled_down(jax_get_arch(args.arch), width=args.width)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(args.seed)))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(7),
                                            (args.prompts, args.prompt_len), 0, cfg.vocab))
    return params_from_jax(params, "cpu"), torch.from_numpy(prompts.astype(np.int32))


def _check_stream(got, want, dtype):
    """float32: JAX's stream exactly.  bfloat16: XLA's CPU exp is not
    correctly rounded and its sums run in 32-wide windows, so softmax
    weights differ from the port's in the last f32 bit now and then; after
    16 steps one session of the four reaches a near tie that these flip.
    Held: at least three sessions equal JAX's over all 64 steps, and none
    forks within the first 8 (one flush window)."""
    assert got.shape == want.shape == (4, 32 + 64 + 1)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    equal = [bool(np.array_equal(got[b], want[b])) for b in range(4)]
    assert sum(equal) >= 3, equal
    np.testing.assert_array_equal(got[:, :32 + 1 + 8], want[:, :32 + 1 + 8])


def test_serve_matches_jax_stream(tmp_path, dtype):
    want = _jax_stream(tmp_path / "jax")
    params, prompts = _jax_weights_and_prompts(dtype)
    args = serve.parser().parse_args(["--device", "cpu", "--workdir", str(tmp_path / "torch")])
    stats = serve.run(args, params=params, prompts=prompts)
    _check_stream(stats["tokens"], want, dtype)
    assert not stats["resumed"] and stats["decode_steps"] == 64
    assert len(stats["flush_bytes"]) == 8  # every 8 steps


def test_serve_crash_and_resume_matches_jax_stream(tmp_path, dtype):
    want = _jax_stream(tmp_path / "jax")
    params, prompts = _jax_weights_and_prompts(dtype)
    args = serve.parser().parse_args(["--device", "cpu", "--workdir", str(tmp_path / "torch"),
                                      "--inject-failure-at", "32"])
    with pytest.raises(serve.SimulatedFailure):
        serve.run(args, params=params, prompts=prompts)
    args.inject_failure_at = 0
    stats = serve.run(args, params=params, prompts=prompts)
    assert stats["resumed"] and stats["decode_steps"] == 32
    _check_stream(stats["tokens"], want, dtype)


def test_serve_cli_resume_equals_uninterrupted(tmp_path):
    """The CLI's own restart path, with the port's seeded weights: a crash at
    step 32 and a resume give the uninterrupted stream, and every flush of
    the resumed run is a delta flush of a few blocks."""
    base = ["--device", "cpu", "--decode-steps", "48", "--flush-every", "8"]
    clean = serve.main(base + ["--workdir", str(tmp_path / "a")])
    resumed = serve.main(base + ["--workdir", str(tmp_path / "b"), "--inject-failure-at", "32"])
    assert resumed["resumed"] and not clean["resumed"]
    np.testing.assert_array_equal(resumed["tokens"], clean["tokens"])
    # each delta flush: the KV rows of 8 new tokens, in k and in v, for 2
    # layers and 4 sessions, 4 heads x 32 x 2 bytes each (whole 64-byte
    # blocks): 32768 bytes; plus the 8 new tokens of each session (32
    # bytes, in at most 2 blocks), t and the step: at most 10 blocks
    kv = 2 * 8 * 2 * 4 * (4 * 32 * 2)
    assert all(kv < b <= kv + 64 * 10 for b in resumed["flush_bytes"]), resumed["flush_bytes"]
    assert clean["flush_bytes"][0] > 5 * kv  # the first flush writes everything


def test_serve_fleet_projects_the_measured_run(tmp_path, capsys):
    """--fleet after the run: one line per policy, and main() returns the
    document fleet_report gives for the run's stats (and JAX's gives)."""
    argv = ["--device", "cpu", "--decode-steps", "8", "--fleet", "--fleet-horizon", "600",
            "--workdir", str(tmp_path)]
    stats = serve.main(argv)
    out = capsys.readouterr().out
    from repro_torch.core import POLICIES

    for policy in POLICIES:
        assert f"[fleet] {policy:10s} goodput=" in out
    args = serve.parser().parse_args(argv)
    assert stats["fleet"] == serve.fleet_report(stats, args)
    assert stats["fleet"] == jax_serve.fleet_report(stats, args)
    for p in stats["fleet"].values():
        assert p["arrived"] == p["served"] + p["dropped"] + p["in_flight"]


# -------------------------------------------------- bfloat16 leaves (repair)
def _bf16(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["delta", "full", "auto"])
def test_bf16_leaf_flushes_and_restores_byte_identically(tmp_path, mode):
    x = _bf16(3000, 0)
    arena = NVMArena(block_bytes=64, backing_dir=str(tmp_path / "arena"))
    pol = FlushPolicy(leaves=("kv",), async_flush=False, persist_mode=mode)
    mgr = EasyCrashManager(arena, pol)
    for step in range(1, 5):
        x[(step * 397) % x.numel()] += 1.0
        before = mgr.stats.blocks_written
        mgr.maybe_flush(step, {"kv": x})
        assert arena.peek("kv").tobytes() == x.view(torch.int16).numpy().tobytes()
        if step > 1 and mode != "full":
            assert mgr.stats.blocks_written - before == 2  # one kv block, __step__
    for source in (arena, NVMArena.reattach(str(tmp_path / "arena"))):
        fresh = EasyCrashManager(source, pol)
        got, step, src = fresh.restore({"kv": torch.zeros_like(x)})
        assert (step, src) == (4, "easycrash")
        assert got["kv"].dtype == torch.bfloat16
        assert torch.equal(got["kv"].view(torch.int16), x.view(torch.int16))
        # the restore seeded the delta shadow: the next flush writes one block
        x2 = got["kv"].clone()
        x2[5] += 1.0
        before = fresh.stats.blocks_written
        fresh.maybe_flush(5, {"kv": x2})
        assert source.peek("kv").tobytes() == x2.view(torch.int16).numpy().tobytes()
        if mode == "delta":
            assert fresh.stats.blocks_written - before == 2


def test_convert_round_trips_bf16_bytes():
    jax_bf16 = np.asarray(jax.numpy.asarray(np.linspace(-3, 3, 37, dtype=np.float32),
                                            jax.numpy.bfloat16))
    t = state_to_torch({"a": jax_bf16}, "cpu")["a"]
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == jax_bf16.view(np.uint16).tobytes()
    back = state_to_numpy({"a": t})["a"]
    assert back.dtype == np.int16 and back.tobytes() == jax_bf16.tobytes()
    assert host_array(t).tobytes() == back.tobytes()
    tree = params_from_jax({"g": {"w": jax_bf16, "n": np.arange(4, dtype=np.int32)}}, "cpu")
    assert tree["g"]["w"].dtype == torch.bfloat16 and tree["g"]["n"].dtype == torch.int32
