"""Granite-4.0-H's kernels on a CUDA device: ``ssm_update`` against its
plain version, ``flash_attention`` with a scale against the plain version,
and the server at a reduced width through both kernels, resumed after a
crash.  Every test needs a card (marker ``cuda``) and skips without one;
this file imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_granite4h_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.ssm_update import ssm_update
from repro_torch.kernels.ssm_update.ref import ssm_update_reference

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(b, h, p, n, g, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (r(b, h, p, n), r(b, h, p), torch.nn.functional.softplus(r(b, h) - 2),
            -(1 + 15 * torch.rand(h, generator=gen, device="cuda")), r(b, g, n), r(b, g, n),
            r(h))


@pytest.mark.parametrize("b,h,p,n,g", [(32, 64, 64, 128, 1), (3, 6, 10, 20, 2),
                                       (2, 4, 33, 256, 4), (1, 2, 8, 512, 1), (5, 3, 64, 4, 3)])
def test_ssm_update_kernel_equals_plain_version(b, h, p, n, g):
    hs, x, dt, A, B, C, D = _inputs(b, h, p, n, g, seed=n)
    want_h = hs.clone()
    want_y = ssm_update_reference(want_h, x, dt, A, B, C, D)
    before = ssm_update.launches
    y = ssm_update(hs, x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert ssm_update.launches == before + 1
    torch.testing.assert_close(hs, want_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)


def test_ssm_update_updates_a_cache_layer_in_place():
    cache = torch.zeros(3, 4, 8, 16, 128, device="cuda")
    _, x, dt, A, B, C, D = _inputs(4, 8, 16, 128, 1)
    ssm_update(cache[1], x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert cache[1].abs().sum() > 0 and cache[0].abs().sum() == 0 and cache[2].abs().sum() == 0


def test_ssm_update_rejects_what_it_does_not_take():
    hs, x, dt, A, B, C, D = _inputs(2, 4, 8, 16, 1)
    with pytest.raises(TypeError):
        ssm_update(hs.bfloat16(), x, dt, A, B, C, D)
    with pytest.raises(ValueError):
        ssm_update(hs[..., :14], x, dt, A, B[..., :14], C[..., :14], D)  # N % 4
    with pytest.raises(ValueError):
        ssm_update(hs, x.transpose(0, 1).contiguous().transpose(0, 1), dt, A, B, C, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_with_a_scale_equals_plain_version(dtype):
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(2, 256, 8, 64, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    got = flash_attention(q, k, v, scale=0.015625)
    want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True, scale=0.015625).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v, scale=64 ** -0.5))


def test_serve_granite_on_device_uses_the_kernels_and_resumes(tmp_path):
    from repro_torch.launch import serve

    base = ["--arch", "granite-4.0-h-micro", "--decode-steps", "24", "--flush-every", "8",
            "--width", "256", "--prompt-len", "128"]
    fa, su = flash_attention.launches, ssm_update.launches
    clean = serve.main(base + ["--workdir", str(tmp_path / "a")])
    assert flash_attention.launches == fa + 1  # one attention layer at scaled_down
    assert ssm_update.launches == su + 24 * 5  # five Mamba-2 layers a step
    resumed = serve.main(base + ["--workdir", str(tmp_path / "b"), "--inject-failure-at", "16"])
    assert resumed["resumed"]
    np.testing.assert_array_equal(resumed["tokens"], clean["tokens"])
