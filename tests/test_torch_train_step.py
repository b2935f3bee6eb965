"""The port's train step (repro_torch.launch.steps.make_train_step) against
the JAX package's jitted one, on the CPU: the same initial state
(convert.train_state_from_jax of JAX's init_train_state) and the same
numpy-seeded batches, at a scaled-down StableLM config (width 64, 2 layers)
with grad_accum 2, after 1 and 3 steps.

Tolerances, float32:
* loss and grad_norm to 1e-6 relative (the backward sums in another order);
  lr exactly;
* new parameters to 0.05 x lr per element: Adam's early updates are about
  lr x sign(g) where |g| >> eps, so an element whose gradient is float
  noise near eps moves by a visibly different fraction of lr in the two
  packages (measured: up to 0.017 lr);
* mu and nu to 2e-4 of each leaf's largest magnitude (measured: 5e-5).

bfloat16 (the config's own dtype): the forward is JAX's compiled rounding
bit for bit (the first loss is equal), the bfloat16 backward is not
(autograd and XLA round the bfloat16 products' gradients at other points):
* loss and grad_norm to 1e-3 relative (measured: 3.3e-4);
* each parameter within steps x (lr + 2^-7 |p|), an lr-sized update per
  step plus one bfloat16 ulp of rounding (measured: 2.5 after 3 steps);
* mu and nu to 5e-2 of each leaf's largest magnitude (measured: 2.9e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.steps import init_train_state as jax_init_train_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import scaled_down as jax_scaled_down
from repro_torch.configs import get_arch
from repro_torch.convert import train_state_from_jax
from repro_torch.core.manager import flatten_state
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import scaled_down

LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _flat_jax(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(dtype):
    jcfg = dataclasses.replace(jax_scaled_down(jax_get_arch("stablelm-1.6b"), width=64),
                               dtype=dtype, grad_accum=2)
    cfg = dataclasses.replace(scaled_down(get_arch("stablelm-1.6b"), width=64),
                              dtype=dtype, grad_accum=2)
    return jcfg, cfg


def _run(dtype, steps):
    jcfg, cfg = _configs(dtype)
    jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    state = train_state_from_jax(jstate, "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg, total_steps=50, warmup=2, peak_lr=LR))
    step = make_train_step(cfg, total_steps=50, warmup=2, peak_lr=LR)
    rng = np.random.default_rng(1)
    metrics = []
    for _ in range(steps):
        tokens = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append((jm, m))
    return jstate, state, metrics


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_f32_grad_accum_matches_jax(steps):
    jstate, state, metrics = _run("float32", steps)
    for jm, m in metrics:
        assert set(m) == {"loss", "lr", "grad_norm"}
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in m.values())
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(state["step"]) == int(jstate["step"]) == steps
    assert int(state["opt"]["count"]) == int(jstate["opt"]["count"]) == steps
    want = _flat_jax(jstate["params"])
    got = flatten_state(state["params"])
    assert set(want) == set(got)
    for k, a in want.items():
        assert got[k].dtype == torch.float32
        assert np.abs(got[k].numpy() - a).max() <= 0.05 * LR, k
    for part in ("mu", "nu"):
        want = _flat_jax(jstate["opt"][part])
        got = flatten_state(state["opt"][part])
        for k, a in want.items():
            np.testing.assert_allclose(got[k].numpy(), a, rtol=0,
                                       atol=2e-4 * np.abs(a).max(), err_msg=f"{part} {k}")


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_bf16_grad_accum_matches_jax(steps):
    jstate, state, metrics = _run("bfloat16", steps)
    jm, m = metrics[0]
    assert float(m["loss"]) == float(jm["loss"])  # the first forward: the same bits
    for jm, m in metrics:
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-3)
        assert float(m["lr"]) == float(jm["lr"])
    want = _flat_jax(jstate["params"])
    got = flatten_state(state["params"])
    for k, a in want.items():
        assert got[k].dtype == torch.bfloat16
        d = np.abs(got[k].float().numpy() - a)
        assert (d <= steps * (LR + 2.0 ** -7 * np.abs(a))).all(), k
    for part in ("mu", "nu"):
        want = _flat_jax(jstate["opt"][part])
        got = flatten_state(state["opt"][part])
        for k, a in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), a, rtol=0,
                                       atol=5e-2 * np.abs(a).max(), err_msg=f"{part} {k}")


def test_train_step_leaves_its_input_state_and_stays_on_device():
    """A new state comes back (the old one is left as it was); the moments
    take the config's moment dtype, and count and step are 0-d int32."""
    _, cfg = _configs("float32")
    cfg = dataclasses.replace(cfg, moment_dtype="bfloat16")
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in flatten_state(state).items()}
    step = make_train_step(cfg, total_steps=10, warmup=2, peak_lr=LR)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (4, 17))
                              .astype(np.int32))
    new, m = step(state, {"tokens": tokens})
    for k, v in flatten_state(state).items():
        assert torch.equal(v, before[k]), k
    flat = flatten_state(new)
    assert all(flat[k].dtype == torch.bfloat16 for k in flat if k.startswith("opt/mu/"))
    assert new["step"].dtype == torch.int32 and new["step"].dim() == 0
    assert new["opt"]["count"].dtype == torch.int32 and int(new["opt"]["count"]) == 1
    assert not any(v.requires_grad for v in flat.values())
