"""The decode server on the MoE archs (Qwen1.5-MoE-A2.7B, Llama-4-Scout), on
the CPU, against the JAX package's server.

The CLI's reduced defaults (width 128, 4 prompts of 32 tokens, so 128
prefill tokens in 32 dispatch groups; 64 steps, a flush every 8) in float32,
given JAX's weights and prompts: JAX's token stream exactly, uninterrupted
and after a crash at step 32 and a resume from the arena; every flushed
image equals the live bytes.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.arena import NVMArena as JaxNVMArena
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init_params
from repro.models import scaled_down as jax_scaled_down
from repro_torch.convert import host_array, params_from_jax
from repro_torch.core.manager import flatten_state
from repro_torch.launch import serve

ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _f32(get_arch_fn):
    return lambda name: dataclasses.replace(get_arch_fn(name), dtype="float32")


def _check_images(step, state, arena):
    for name, live in flatten_state(state).items():
        img = arena.peek(name)
        assert img is not None and img.tobytes() == host_array(live).tobytes(), (step, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_f32_matches_jax_stream_uninterrupted_and_resumed(arch, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_serve, "get_arch", _f32(jax_get_arch))
    jax_serve.main(["--arch", arch, "--workdir", str(tmp_path / "jax")])
    want = JaxNVMArena.reattach(os.path.join(str(tmp_path / "jax"), "serve_arena")).get("tokens")

    monkeypatch.setattr(serve, "get_arch", _f32(serve.get_arch))
    base = ["--device", "cpu", "--arch", arch]
    args = serve.parser().parse_args(base + ["--workdir", str(tmp_path / "clean")])
    cfg = dataclasses.replace(jax_scaled_down(jax_get_arch(arch), width=args.width),
                              dtype="float32")
    params = params_from_jax(
        jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(args.seed))), "cpu")
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(7),
                                            (args.prompts, args.prompt_len), 0, cfg.vocab))
    prompts = torch.from_numpy(prompts.astype(np.int32))
    clean = serve.run(args, params=params, prompts=prompts, on_flush=_check_images)
    assert clean["tokens"].shape == want.shape == (4, 32 + 64 + 1)
    np.testing.assert_array_equal(clean["tokens"], want)
    assert len(clean["flush_bytes"]) == 8

    args = serve.parser().parse_args(base + ["--workdir", str(tmp_path / "crash"),
                                             "--inject-failure-at", "32"])
    with pytest.raises(serve.SimulatedFailure):
        serve.run(args, params=params, prompts=prompts, on_flush=_check_images)
    args.inject_failure_at = 0
    resumed = serve.run(args, params=params, prompts=prompts, on_flush=_check_images)
    assert resumed["resumed"] and resumed["decode_steps"] == 32
    np.testing.assert_array_equal(resumed["tokens"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_resume_equals_uninterrupted(arch, tmp_path):
    """The CLI's own restart path with the port's seeded bf16 weights: the
    resumed stream equals the uninterrupted one."""
    base = ["--device", "cpu", "--arch", arch, "--decode-steps", "24", "--flush-every", "8"]
    clean = serve.main(base + ["--workdir", str(tmp_path / "a")])
    resumed = serve.main(base + ["--workdir", str(tmp_path / "b"), "--inject-failure-at", "16"])
    assert resumed["resumed"] and not clean["resumed"]
    np.testing.assert_array_equal(resumed["tokens"], clean["tokens"])
