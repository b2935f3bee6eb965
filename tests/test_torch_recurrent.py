"""The port's recurrent model families (RWKV6-3B, RecurrentGemma-9B) against
the JAX package's, on the CPU.

Both packages get the same weights: JAX's ``init_params`` of the
``scaled_down`` config (width 64; RWKV one layer of head dim 16,
RecurrentGemma one (rec, rec, attn) repeat with a window of 32), converted
leaf for leaf by ``params_from_jax``.  float32 is held to 1e-4 (abs and rel):
the two differ in the order of f32 sums and, in the RG-LRU, in the scan's
order (JAX's reference is an associative_scan).  bfloat16 is held to a
stated tolerance: XLA's f32 exp and logistic differ from torch's in the last
bit now and then, which flips a bf16 rounding here and there.

The server (``serve.run --device cpu``) is held to JAX's float32 token
stream exactly, uninterrupted and after a crash and a resume; every flush of
the recurrent state leaves an arena image equal to the live bytes.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.arena import NVMArena as JaxNVMArena
from repro.launch import serve as jax_serve
from repro.launch.serve import _splice_cache as jax_splice_cache
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import scaled_down as jax_scaled_down
from repro_torch.configs import get_arch
from repro_torch.convert import host_array, params_from_jax
from repro_torch.core.manager import flatten_state
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill, scaled_down

F32_TOL = 1e-4
ARCHS = ["rwkv6-3b", "recurrentgemma-9b"]
#: the state leaves of each family's decode cache, per layer position
STATE_LEAVES = {"rwkv6-3b": {"pos0": ("S", "x_last")},
                "recurrentgemma-9b": {"pos0": ("h", "conv"), "pos1": ("h", "conv"),
                                      "pos2": ("k", "v")}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(arch, dtype):
    jcfg = jax_scaled_down(jax_get_arch(arch), width=64)
    tcfg = scaled_down(get_arch(arch), width=64)
    return dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(tcfg, dtype=dtype)


def _weights(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jp, "cpu")


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_f32_leaves_of_a_bf16_model(arch):
    """lamb, decay_base and bonus_u are float32 in a bfloat16 model; every
    leaf comes over with its dtype, shape and bytes."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _weights(jcfg)
    f32_leaves = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = _leaf(tp, path)
        assert tuple(t.shape) == leaf.shape
        if leaf.dtype == np.float32:
            f32_leaves.add(path[-1].key)
            assert t.dtype == torch.float32
            assert t.numpy().tobytes() == leaf.tobytes()
        else:
            assert t.dtype == torch.bfloat16
            assert t.view(torch.int16).numpy().tobytes() == leaf.view(np.int16).tobytes()
    want = {"decay_base", "bonus_u"} if arch == "rwkv6-3b" else {"lamb"}
    assert f32_leaves == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = init_params(tcfg, torch.Generator().manual_seed(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = _leaf(tp, path)
        assert tuple(t.shape) == leaf.shape
        assert t.dtype == (torch.float32 if leaf.dtype == np.float32 else torch.bfloat16)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_f32_matches_jax(arch, impl):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _weights(jcfg)
    toks = _tokens(jcfg, 2, 32)
    want, _ = jax_forward(jcfg, jp, jnp.asarray(toks))
    got, aux = forward(tcfg, tp, torch.from_numpy(toks), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch):
    """bfloat16 logits within 0.1 (abs) of JAX's, whose largest are about 4."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _weights(jcfg)
    toks = _tokens(jcfg, 2, 32)
    want = np.asarray(jax_forward(jcfg, jp, jnp.asarray(toks))[0]).astype(np.float32)
    got = forward(tcfg, tp, torch.from_numpy(toks), impl="kernel")[0].float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-1, rtol=0)


def _check_cache(tcache, jcache, arch):
    for pos, leaves in STATE_LEAVES[arch].items():
        for leaf in leaves:
            np.testing.assert_allclose(
                tcache["group0"][pos][leaf].float().numpy(),
                np.asarray(jcache["group0"][pos][leaf]).astype(np.float32),
                atol=F32_TOL, rtol=F32_TOL, err_msg=f"{pos}/{leaf}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_f32_match_jax(arch):
    """prefill logits and cache, then 12 greedy decode steps, to 1e-4; the
    prompt fills RecurrentGemma's window of 32 exactly (see ROADMAP §3 on
    prompts longer than the window)."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _weights(jcfg)
    b, s, steps = 2, 32, 12
    max_len = s + steps + 1
    toks = _tokens(jcfg, b, s)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks))
    tl, tc = prefill(tcfg, tp, torch.from_numpy(toks), impl="kernel")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    _check_cache(tc, jc, arch)
    assert int(tc["t"]) == int(jc["t"]) == s

    jcache = jax_splice_cache(jcfg, jax_init_cache(jcfg, b, max_len), jc, s)
    tcache = serve._splice_cache(tcfg, init_cache(tcfg, b, max_len, device="cpu"), tc, s)
    _check_cache(tcache, jcache, arch)
    jstep = jax.jit(functools.partial(jax_decode_step, jcfg))
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    for _ in range(steps):
        jlog, jcache = jstep(jp, jtok, jcache)
        # both sides are fed JAX's token, so a near tie cannot fork the streams
        tlog, tcache = decode_step(tcfg, tp, torch.from_numpy(np.array(jtok)), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=F32_TOL, rtol=F32_TOL)
        jtok = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)[:, None]
    assert int(tcache["t"]) == int(jcache["t"]) == s + steps
    _check_cache(tcache, jcache, arch)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_takes_the_state_from_the_scan(arch, impl, monkeypatch):
    """prefill runs one scan per recurrent layer (the layer's own, which
    hands its final state to the cache: no second scan), and the cache's
    recurrent leaves are bit for bit what each layer's scan returns."""
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan import ref as rglru_ref
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as rwkv_ref

    calls = {"scan": 0}
    states = []

    def counted(fn, keep_state):
        def wrapper(*a, **kw):
            calls["scan"] += 1
            out = fn(*a, **kw)
            if keep_state:
                states.append(out[1])
            return out
        return wrapper

    rwkv = arch == "rwkv6-3b"
    mod, ref_mod = (rwkv_ops, rwkv_ref) if rwkv else (rglru_ops, rglru_ref)
    name = "rwkv6_scan" if rwkv else "rglru_scan"
    ref_name = "rwkv6_reference" if rwkv else "rglru_reference"
    target = (mod, name) if impl == "kernel" else (ref_mod, ref_name)
    monkeypatch.setattr(*target, counted(getattr(*target), keep_state=rwkv))
    jcfg, tcfg = _cfgs(arch, "float32")
    _, tp = _weights(jcfg)
    _, cache = prefill(tcfg, tp, torch.from_numpy(_tokens(jcfg, 2, 32)), impl=impl)
    n_rec = sum(sum(k in ("rec", "rwkv") for k in pattern) * rep for pattern, rep in tcfg.groups)
    assert calls["scan"] == n_rec
    if rwkv:
        assert torch.equal(cache["group0"]["pos0"]["S"], torch.stack(states))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_updates_the_cache_in_place(arch):
    """decode_step writes the new state into the cache's own tensors, so a
    manager handed the cache once flushes the live state."""
    _, tcfg = _cfgs(arch, "float32")
    tp = init_params(tcfg, torch.Generator().manual_seed(0))
    cache = init_cache(tcfg, 2, 16, device="cpu")
    leaves = {(pos, leaf): cache["group0"][pos][leaf] for pos, ls in STATE_LEAVES[arch].items()
              for leaf in ls}
    before = {k: v.clone() for k, v in leaves.items()}
    _, new = decode_step(tcfg, tp, torch.tensor([[1], [2]], dtype=torch.int32), cache)
    for (pos, leaf), t in leaves.items():
        assert new["group0"][pos][leaf] is t
        assert not torch.equal(t, before[(pos, leaf)]), (pos, leaf)


# ---------------------------------------------------------------- server
def _f32(get_arch_fn):
    return lambda name: dataclasses.replace(get_arch_fn(name), dtype="float32")


def _jax_stream(arch, workdir, monkeypatch):
    monkeypatch.setattr(jax_serve, "get_arch", _f32(jax_get_arch))
    jax_serve.main(["--arch", arch, "--workdir", str(workdir)])
    return JaxNVMArena.reattach(os.path.join(str(workdir), "serve_arena")).get("tokens")


def _jax_weights_and_prompts(arch):
    args = serve.parser().parse_args(["--device", "cpu", "--arch", arch])
    cfg = dataclasses.replace(jax_scaled_down(jax_get_arch(arch), width=args.width),
                              dtype="float32")
    params = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(args.seed)))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(7),
                                            (args.prompts, args.prompt_len), 0, cfg.vocab))
    return params_from_jax(params, "cpu"), torch.from_numpy(prompts.astype(np.int32))


def _check_images(step, state, arena):
    for name, live in flatten_state(state).items():
        img = arena.peek(name)
        assert img is not None and img.tobytes() == host_array(live).tobytes(), (step, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_f32_matches_jax_stream_uninterrupted_and_resumed(arch, tmp_path, monkeypatch):
    """The CLI's reduced defaults (width 128, 4 prompts of 32 tokens, 64
    steps, a flush every 8) in float32, given JAX's weights and prompts:
    JAX's token stream exactly, uninterrupted and after a crash at step 32
    and a resume from the arena; every flushed image equals the live bytes."""
    want = _jax_stream(arch, tmp_path / "jax", monkeypatch)
    monkeypatch.setattr(serve, "get_arch", _f32(serve.get_arch))
    params, prompts = _jax_weights_and_prompts(arch)
    base = ["--device", "cpu", "--arch", arch]
    args = serve.parser().parse_args(base + ["--workdir", str(tmp_path / "clean")])
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
    if arch == "rwkv6-3b":
        # the state S is rewritten whole by every token: a delta flush writes
        # all of it (1 layer x 4 sessions x 8 heads x 16 x 16 f32)
        s_bytes = 4 * 8 * 16 * 16 * 4
        assert all(b > s_bytes for b in resumed["flush_bytes"]), resumed["flush_bytes"]
