"""Granite-4.0-H (Mamba-2 and NoPE GQA layers, configs.PORT_ARCHS) on the
CPU, in float32, against the plain reference ``bench/reference/granite4h.py``
on the same weights: the port's forward; its prefill and decode through the
cache at every position; its chunked scan and ``ssm_update``'s plain
version against the reference's sequential recurrence; the reference's two
scan forms against each other; a served run resumed after a crash; the
registry, the config and the attention scale.  Tolerance 1e-4 (relative
to the reference's largest value): both sides compute in float32 and sum
in other orders.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.configs import ARCHS, PORT_ARCHS, arch_names, get_arch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.ssm_update import ssm_update
from repro_torch.launch.serve import _splice_cache
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill, scaled_down
from repro_torch.models.config import HybridConfig, ModelConfig, groups_from_layer_types
from repro_torch.models.mamba2 import ssd_chunked

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.inputs import granite4h as inputs  # noqa: E402
from bench.reference import granite4h as ref  # noqa: E402

TOL = 1e-4
NAME = "granite-4.0-h-micro"
HF = PORT_ARCHS[NAME]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfg(types=("mamba", "mamba", "attention", "mamba", "attention", "mamba")):
    """A small hybrid in float32 with GQA (4 q heads over 2), chunks of 8."""
    from repro_torch.configs.granite_4_0_h_micro import HF_CONFIG, from_hf

    hf = dict(HF_CONFIG, hidden_size=64, shared_intermediate_size=96, num_attention_heads=4,
              num_key_value_heads=2, mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
              mamba_chunk_size=8, vocab_size=256, layer_types=list(types),
              num_hidden_layers=len(types))
    return hf, from_hf(hf, "granite-small", dtype="float32")


def _params(cfg, seed=0):
    """init_params' tree with every norm, bias and D perturbed, so that a
    weight applied wrongly shows."""
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("norm1", "norm2", "final_norm", "norm", "conv_b", "D"):
                v.add_(0.3 * torch.randn(v.shape, generator=gen))
    perturb(params)
    return params


def _tokens(cfg, b, s, seed=1):
    return torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(seed))


def _states(cfg, cache):
    out = []
    for gi, (pattern, n) in enumerate(cfg.groups):
        for i in range(n):
            for pi, kind in enumerate(pattern):
                if kind == "mamba":
                    out.append(cache[f"group{gi}"][f"pos{pi}"]["ssm"][i])
    return torch.stack(out)


def test_forward_matches_reference():
    hf, cfg = _cfg()
    params = _params(cfg)
    toks = _tokens(cfg, 2, 29)
    got, aux = forward(cfg, params, toks)
    want, _ = ref.forward(hf, inputs.layer_views(cfg, params), toks, scan="sequential",
                          all_positions=True)
    assert float(aux) == 0.0
    assert ref.relative_gap(got, want) < TOL


@pytest.mark.parametrize("prompt", [13, 16])
def test_prefill_and_decode_match_the_reference_at_every_position(prompt):
    hf, cfg = _cfg()
    params = _params(cfg, seed=prompt)
    steps = 8
    toks = _tokens(cfg, 2, prompt + steps, seed=prompt)
    want, want_states = ref.forward(hf, inputs.layer_views(cfg, params), toks,
                                    scan="sequential", all_positions=True)
    logits, pcache = prefill(cfg, params, toks[:, :prompt])
    assert ref.relative_gap(logits, want[:, prompt - 1]) < TOL
    cache = _splice_cache(cfg, init_cache(cfg, 2, prompt + steps + 1, "cpu"), pcache, prompt)
    for t in range(prompt, prompt + steps):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        assert ref.relative_gap(logits[:, 0], want[:, t]) < TOL, t
    assert int(cache["t"]) == prompt + steps
    assert ref.relative_gap(_states(cfg, cache), want_states) < TOL


def _scan_inputs(b, s, h, p, g, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen) - 2)
    A = -(1 + 15 * torch.rand(h, generator=gen))
    B, C = (torch.randn(b, s, g, n, generator=gen) for _ in range(2))
    return x, dt, A, B, C


@pytest.mark.parametrize("s,chunk,g", [(13, 8, 1), (37, 8, 2), (16, 8, 1), (5, 8, 1)])
def test_port_chunked_scan_matches_the_sequential_recurrence(s, chunk, g):
    x, dt, A, B, C = _scan_inputs(2, s, 4, 6, g, 10, seed=s)
    y, h = ssd_chunked(x, dt, A, B, C, chunk)
    want_y, want_h = ref.scan_sequential(x, dt, A, B, C)
    assert ref.relative_gap(y, want_y) < TOL and ref.relative_gap(h, want_h) < TOL


@pytest.mark.parametrize("s,chunk", [(13, 8), (40, 8), (3, 4)])
def test_reference_chunked_form_matches_its_sequential_form(s, chunk):
    x, dt, A, B, C = _scan_inputs(2, s, 4, 6, 2, 10, seed=s + 1)
    y, h = ref.scan_chunked(x, dt, A, B, C, chunk)
    want_y, want_h = ref.scan_sequential(x, dt, A, B, C)
    assert y.shape == want_y.shape
    assert ref.relative_gap(y, want_y) < TOL and ref.relative_gap(h, want_h) < TOL


@pytest.mark.parametrize("g", [1, 2])
def test_ssm_update_plain_version_is_one_reference_step(g):
    x, dt, A, B, C = _scan_inputs(3, 9, 4, 6, g, 12, seed=g)
    D = torch.randn(4, generator=torch.Generator().manual_seed(5))
    want_y, want_h = ref.scan_sequential(x, dt, A, B, C)
    _, h = ref.scan_sequential(x[:, :-1], dt[:, :-1], A, B[:, :-1], C[:, :-1])
    before = ssm_update.launches
    y = ssm_update(h, x[:, -1].contiguous(), dt[:, -1].contiguous(), A, B[:, -1].contiguous(),
                   C[:, -1].contiguous(), D)
    assert ssm_update.launches == before  # no kernel on the CPU
    assert ref.relative_gap(h, want_h) < TOL  # updated in place
    assert ref.relative_gap(y, want_y[:, -1] + D[:, None] * x[:, -1]) < TOL


def test_ssm_update_checks_its_shapes():
    h = torch.zeros(2, 4, 6, 8)
    x, dt, A, D = torch.zeros(2, 4, 6), torch.zeros(2, 4), torch.zeros(4), torch.zeros(4)
    B = torch.zeros(2, 3, 8)  # 3 groups do not divide 4 heads
    with pytest.raises(ValueError):
        ssm_update(h, x, dt, A, B, B, D)
    with pytest.raises(ValueError):
        ssm_update(h, x[:, :2], dt, A, torch.zeros(2, 1, 8), torch.zeros(2, 1, 8), D)


def test_decode_and_prefill_put_each_mamba_run_in_one_range():
    """Five runs of Mamba-2 layers in the published pattern: five
    ``model.mamba`` ranges a step, none per layer."""
    types = [{"attn": "attention"}.get(k, k) for pat, n in HF.groups for _ in range(n)
             for k in pat]
    hf, cfg = _cfg(types)
    assert cfg.n_layers == 40
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = _tokens(cfg, 1, 9)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _, pcache = prefill(cfg, params, toks)
    assert sum(e.name == "model.mamba" for e in prof.events()) == 5
    cache = _splice_cache(cfg, init_cache(cfg, 1, 12, "cpu"), pcache, 9)
    with torch.profiler.profile(activities=acts) as prof:
        decode_step(cfg, params, toks[:, -1:], cache)
    assert sum(e.name == "model.mamba" for e in prof.events()) == 5


def test_serve_resumes_to_the_uninterrupted_stream(tmp_path):
    from repro_torch.launch import serve

    base = ["--device", "cpu", "--arch", NAME, "--width", "64", "--prompts", "2",
            "--prompt-len", "13", "--decode-steps", "24", "--flush-every", "8"]
    clean = serve.main(base + ["--workdir", str(tmp_path / "a")])
    resumed = serve.main(base + ["--workdir", str(tmp_path / "b"), "--inject-failure-at", "16"])
    assert resumed["resumed"] and not clean["resumed"]
    assert resumed["decode_steps"] == 8
    assert (resumed["tokens"] == clean["tokens"]).all()
    assert clean["tokens"][:, 14:].any()  # decoded


def test_registry_keeps_the_ten_and_finds_the_port_arch():
    assert set(ARCHS) == set(JAX_ARCHS) and len(ARCHS) == 10
    assert NAME not in ARCHS and NAME not in JAX_ARCHS
    cfg = get_arch(NAME)
    assert cfg is HF
    assert isinstance(cfg, HybridConfig) and NAME in arch_names()
    assert set(arch_names()) == set(ARCHS) | {NAME}
    # ModelConfig keeps exactly JAX's fields, so asdict of the ten stays JAX's
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert names == [f.name for f in dataclasses.fields(JaxModelConfig)]


def test_config_holds_the_published_numbers():
    cfg = get_arch(NAME)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == \
        (40, 2048, 32, 8, 64)
    assert (cfg.d_ff, cfg.vocab, cfg.tie_embeddings, cfg.norm_eps) == (8192, 100352, True, 1e-5)
    m = cfg.mamba
    assert (m.n_heads, m.head_dim, m.d_state, m.n_groups, m.d_conv, m.chunk) == \
        (64, 64, 128, 1, 4, 256)
    assert m.d_inner == 4096 and m.conv_dim == 4352
    assert cfg.groups == ((("mamba",) * 5 + ("attn",), 1), (("mamba",) * 9 + ("attn",), 3),
                          (("mamba",) * 4, 1))
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.logits_scaling,
            cfg.attn_scale, cfg.rope) == (12.0, 0.22, 8.0, 0.015625, False)
    small = scaled_down(cfg, width=64)
    assert {k for pat, _ in small.groups for k in pat} == {"mamba", "attn"}
    assert small.mamba.d_inner == 2 * 64 and small.mamba.chunk == 8


def test_groups_from_layer_types():
    assert groups_from_layer_types(["mamba", "attention", "mamba", "attention", "mamba"]) == \
        ((("mamba", "attn"), 2), (("mamba",), 1))
    assert groups_from_layer_types(["attention"] * 3) == ((("attn",), 3),)


def test_flash_attention_default_scale_keeps_its_bits_on_the_stablelm_shape():
    cfg = get_arch("stablelm-1.6b")
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 128, 4, cfg.head_dim, generator=gen).bfloat16() for _ in range(3))
    got = flash_attention(q, k, v)
    before = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=True).transpose(1, 2)
    assert torch.equal(got, before)
    assert torch.equal(got, flash_attention(q, k, v, scale=cfg.head_dim ** -0.5))


def test_flash_attention_scale_equals_a_prescaled_q():
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 64, 3, 64, generator=gen) for _ in range(3))
    c = 0.015625
    got = flash_attention(q, k, v, scale=c)
    want = flash_attention(q * (c / 64 ** -0.5), k, v)
    assert ref.relative_gap(got, want) < 1e-5
    assert ref.relative_gap(got, flash_attention(q, k, v)) > 1e-2  # the scale matters
