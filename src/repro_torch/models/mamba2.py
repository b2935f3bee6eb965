"""Mamba-2 mixer (Dao & Gu, arXiv:2405.21060), as IBM's Granite-4.0-H
layers use it (HF transformers' GraniteMoeHybridMambaLayer, n_groups G):

    zxbcdt = x @ in_proj                        z (Di), xBC (Di + 2GN), dt (H)
    xBC    = silu(causal_depthwise_conv(xBC) + conv_b)   -> x (H, P), B (G, N), C (G, N)
    dt     = softplus(dt + dt_bias),  A = -exp(A_log)
    h_t    = exp(dt_t A) h_{t-1} + (dt_t x_t) outer B_t      (per head: P x N)
    y_t    = h_t C_t + D x_t
    out    = RMSNorm(y * silu(z)) @ out_proj                   (over Di = H P)

The JAX package has no such layer; the port runs it for the archs in
``configs.PORT_ARCHS``.  The state and the scan run in float32 whatever the
model's dtype; the conv's output is rounded to the model's dtype, as a
bfloat16 conv layer's would be.

* The prefill (:func:`mamba_full`) runs the state-space duality's chunked
  form as batched products, a Python loop over chunks of ``chunk`` tokens
  carrying the state (:func:`ssd_chunked`); it returns the decode cache's
  leaves: the final state and the conv's last ``d_conv - 1`` inputs.
* Decode (:func:`mamba_decode_step`) shifts the conv state and updates the
  state in place with the ``ssm_update`` kernel (its plain version on a
  CPU tensor).
* The gated norm's weight is stored as ``gamma`` and applied as
  ``1 + gamma``, as every norm of the port is (``layers.rms_norm``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dtype_of, matmul, normal_init, rms_norm


def mamba_params(cfg: ModelConfig, gen: torch.Generator, n: int) -> Dict:
    """Stacked parameters of ``n`` layers.  A, dt and D follow Mamba-2's
    initialisation: A uniform on [1, 16], dt log-uniform on [1e-3, 1e-1]
    stored through the inverse softplus, D 1."""
    m, d = cfg.mamba, cfg.d_model
    dt = dtype_of(cfg)
    dev = gen.device
    proj = 2 * m.d_inner + 2 * m.n_groups * m.d_state + m.n_heads
    u = torch.rand((n, m.n_heads), generator=gen, device=dev)
    step = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    a = 1.0 + 15.0 * torch.rand((n, m.n_heads), generator=gen, device=dev)
    return {
        "in_proj": normal_init(gen, (n, d, proj), d ** -0.5, dt),
        "conv_w": normal_init(gen, (n, m.conv_dim, m.d_conv), m.d_conv ** -0.5, dt),
        "conv_b": torch.zeros((n, m.conv_dim), dtype=dt, device=dev),
        "dt_bias": step + torch.log(-torch.expm1(-step)),  # softplus^-1(step)
        "A_log": torch.log(a),
        "D": torch.ones((n, m.n_heads), dtype=torch.float32, device=dev),
        "norm": torch.zeros((n, m.d_inner), dtype=dt, device=dev),
        "out_proj": normal_init(gen, (n, m.d_inner, d), m.d_inner ** -0.5, dt),
    }


def mamba_specs() -> Dict:
    return {"in_proj": (None, "fsdp", None), "conv_w": (None, None, None),
            "conv_b": (None, None), "dt_bias": (None, None), "A_log": (None, None),
            "D": (None, None), "norm": (None, None), "out_proj": (None, None, "fsdp")}


def mamba_init_state(cfg: ModelConfig, n_layers: int, batch: int, device) -> Dict:
    """Decode cache of ``n_layers`` layers: ``ssm`` (L, B, H, P, N) float32
    and ``conv``, the conv's last ``d_conv - 1`` inputs (L, B, Di + 2GN,
    d_conv - 1) in the model's dtype."""
    m = cfg.mamba
    return {
        "ssm": torch.zeros((n_layers, batch, m.n_heads, m.head_dim, m.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, m.conv_dim, m.d_conv - 1), dtype=dtype_of(cfg),
                            device=device),
    }


def mamba_state_specs() -> Dict:
    return {"ssm": (None, "batch", None, None, None), "conv": (None, "batch", None, None)}


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, ...]:
    m = cfg.mamba
    return torch.split(zxbcdt, [m.d_inner, m.conv_dim, m.n_heads], dim=-1)


def _conv(taps: List[torch.Tensor], w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv_b + sum_k w[:, k] * taps[k] in float32, tap by tap (taps[k]: the
    input ``d_conv - 1 - k`` steps back, channels last)."""
    out = b.float().expand(taps[0].shape).clone()
    for k, t in enumerate(taps):
        out.addcmul_(t.float(), w[:, k].float())
    return out


def _inputs(p: Dict, xbc: torch.Tensor, dt: torch.Tensor, cfg: ModelConfig):
    """The conv's activated output split into x (..., H, P), B and C (...,
    G, N), in float32 after a rounding to the model's dtype; dt after its
    bias and softplus; A."""
    m = cfg.mamba
    xbc = F.silu(xbc).to(dtype_of(cfg)).float()
    xs, B, C = torch.split(xbc, [m.d_inner, m.n_groups * m.d_state, m.n_groups * m.d_state],
                           dim=-1)
    lead = xbc.shape[:-1]
    return (xs.reshape(*lead, m.n_heads, m.head_dim).contiguous(),
            B.reshape(*lead, m.n_groups, m.d_state).contiguous(),
            C.reshape(*lead, m.n_groups, m.d_state).contiguous(),
            F.softplus(dt.float() + p["dt_bias"]).contiguous(),
            -torch.exp(p["A_log"].float()))


def _gated_out(p: Dict, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm(y * silu(z)) @ out_proj; y float32 (..., Di), z in the model's dtype."""
    g = F.silu(z.float(), inplace=True).mul_(y)
    return matmul(rms_norm(g, p["norm"], cfg.norm_eps).to(z.dtype), p["out_proj"])


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over a whole sequence from a zero state, in chunks.

    x (b, s, H, P), dt (b, s, H), A (H,), B and C (b, s, G, N), float32.
    Returns y (b, s, H, P) without the ``D x`` term, and the final state
    (b, H, P, N).  Within a chunk of l tokens, with ``a`` the cumulative sum
    of ``dt A`` from the chunk's start, y_t = sum_{u <= t} (C_t . B_u)
    exp(a_t - a_u) dt_u x_u + exp(a_t) C_t . h, and the state leaves it as
    exp(a_l) h + sum_u exp(a_l - a_u) dt_u x_u outer B_u.  ``s`` need not be
    a multiple of ``chunk``.
    """
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, H, P), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        acum = torch.cumsum(dt[:, c0:c1] * A, dim=1)                   # (b, l, H)
        xdt = x[:, c0:c1] * dt[:, c0:c1, :, None]                        # (b, l, H, P)
        Bh = B[:, c0:c1].repeat_interleave(rep, dim=2)                   # (b, l, H, N)
        Ch = C[:, c0:c1].repeat_interleave(rep, dim=2)
        at = acum.transpose(1, 2)                                        # (b, H, l)
        causal = torch.ones(c1 - c0, c1 - c0, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp((at[..., :, None] - at[..., None, :]).masked_fill(~causal, -math.inf))
        cb = torch.einsum("blhn,buhn->bhlu", Ch, Bh)                    # (b, H, l, l)
        yc = torch.einsum("bhlu,buhp->blhp", cb * decay, xdt)
        y[:, c0:c1] = yc + torch.einsum("blhn,bhpn->blhp", Ch, h) * torch.exp(acum)[..., None]
        tail = torch.exp(acum[:, -1:] - acum)                            # (b, l, H)
        h = h * torch.exp(acum[:, -1])[..., None, None] \
            + torch.einsum("blhp,blhn->bhpn", xdt * tail[..., None], Bh)
    return y, h


def mamba_full(p: Dict, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence Mamba-2 mixer.  x: (b, s, d) -> (b, s, d); with
    ``return_state`` also the decode cache's leaves after the sequence,
    {"ssm": (b, H, P, N) float32, "conv": (b, Di + 2GN, d_conv - 1)}."""
    m = cfg.mamba
    b, s, _ = x.shape
    z, xbc, dt = _split(matmul(x, p["in_proj"]), cfg)
    k = m.d_conv
    padded = F.pad(xbc, (0, 0, k - 1, 0))                               # (b, s + k - 1, Cv)
    conv = _conv([padded[:, i:i + s] for i in range(k)], p["conv_w"], p["conv_b"])
    xs, B, C, dt, A = _inputs(p, conv, dt, cfg)
    y, h = ssd_chunked(xs, dt, A, B, C, m.chunk)
    y.addcmul_(xs, p["D"].float()[:, None])
    out = _gated_out(p, y.reshape(b, s, m.d_inner), z, cfg)
    if not return_state:
        return out
    return out, {"ssm": h, "conv": padded[:, s:].transpose(1, 2)}


def mamba_decode_step(p: Dict, x: torch.Tensor, h: torch.Tensor, conv_state: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token.  x: (b, 1, d); h: (b, H, P, N) float32, updated in place;
    conv_state: (b, Di + 2GN, d_conv - 1).  Returns (out (b, 1, d), the new
    conv state)."""
    from ..kernels.ssm_update import ssm_update

    m = cfg.mamba
    b = x.shape[0]
    z, xbc, dt = _split(matmul(x, p["in_proj"])[:, 0], cfg)
    window = torch.cat([conv_state, xbc[:, :, None]], dim=-1)           # (b, Cv, d_conv)
    conv = _conv([window[..., i] for i in range(m.d_conv)], p["conv_w"], p["conv_b"])
    xs, B, C, dt, A = _inputs(p, conv, dt, cfg)
    y = ssm_update(h, xs, dt, A, B, C, p["D"].float().contiguous())
    out = _gated_out(p, y.reshape(b, 1, m.d_inner), z[:, None], cfg)
    return out, window[..., 1:]
