# Port of repro/models/rglru.py.  What differs:
# * impl="kernel" is the counterpart of JAX's impl="pallas": the scan goes
#   to the hand-written CUDA kernel (kernels/rglru_scan; its plain version
#   on a CPU tensor).  impl="reference" and impl="chunked" run the plain
#   sequential scan (kernels/rglru_scan/ref.py) where JAX runs
#   lax.associative_scan for every impl but "pallas": the two sum in
#   another order and agree to about 1e-6 in f32, not bit for bit.  An
#   impl name the port does not know raises ValueError.
# * softplus is written as jax.nn.softplus computes it, logaddexp(x, 0).
# * rglru_params draws from a torch.Generator (other numbers than JAX's
#   keys; tests convert JAX's weights with convert.params_from_jax);
#   rglru_init_state takes a device.
# * rglru_full(..., return_state=True) also returns the decode cache's
#   leaves (h's last step, the pre-conv tail) from the values it computes,
#   which the JAX prefill recomputes (transformer._rec_state_after).
# * with_logical is gone (a no-op on one card); rglru_specs and
#   rglru_state_specs are left out (sharding only).
"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t)            recurrence gate
    i_t = sigmoid(W_x x_t)            input gate
    a_t = a^(c * r_t)                 with a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

preceded by a short causal conv1d, inside a gated block (GeGLU-style).  The
recurrence is *diagonal*; ``repro_torch.kernels.rglru_scan`` holds the
kernel and its plain sequential version.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import ModelConfig
from .layers import activation_fn, dtype_of, matmul, normal_init

_C = 8.0


def rglru_params(cfg: ModelConfig, gen: torch.Generator, n: int) -> Dict:
    d = cfg.d_model
    dr = cfg.rec.d_rnn
    cw = cfg.rec.conv_width
    dt = dtype_of(cfg)
    s = d ** -0.5
    return {
        "w_in_x": normal_init(gen, (n, d, dr), s, dt),     # recurrence branch
        "w_in_g": normal_init(gen, (n, d, dr), s, dt),     # gate branch
        "conv": normal_init(gen, (n, cw, dr), cw ** -0.5, dt),
        "w_gate_a": normal_init(gen, (n, dr, dr), dr ** -0.5, dt),
        "w_gate_x": normal_init(gen, (n, dr, dr), dr ** -0.5, dt),
        # Lambda init so a = sigmoid(L) in ~(0.9, 0.999)
        "lamb": normal_init(gen, (n, dr), 0.5, torch.float32) + 4.0,
        "w_out": normal_init(gen, (n, dr, d), dr ** -0.5, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B,S,dr); w: (cw,dr); prefix: (B,cw-1,dr)."""
    cw = w.shape[0]
    xp = torch.cat([prefix, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + x.shape[1]] * w[cw - 1 - i][None, None, :]
    return out


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _gates(p: Dict, xr: torch.Tensor):
    r = torch.sigmoid(matmul(xr, p["w_gate_a"]).float())
    i = torch.sigmoid(matmul(xr, p["w_gate_x"]).float())
    log_a = -_C * r * _softplus(p["lamb"])[None, None, :]   # log a_t <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xr.float())
    return a, gated_x


def _scan(a: torch.Tensor, gx: torch.Tensor, impl: str) -> torch.Tensor:
    if impl == "kernel":
        from ..kernels.rglru_scan.ops import rglru_scan

        return rglru_scan(a, gx)
    if impl in ("reference", "chunked"):
        from ..kernels.rglru_scan.ref import rglru_reference

        return rglru_reference(a, gx)
    raise ValueError(f"unknown rglru impl {impl!r}; use 'reference', 'kernel' or 'chunked'")


def rglru_full(p: Dict, x: torch.Tensor, cfg: ModelConfig, impl: str = "reference",
               return_state: bool = False):
    """Full-sequence RG-LRU block.  x: (B, S, d) -> (B, S, d); with
    ``return_state`` also the decode cache's leaves after the sequence,
    {"h": the scan's last step (B, dr) f32, "conv": the last cw - 1 steps of
    the conv's input (B, cw - 1, dr)}."""
    b = x.shape[0]
    cw = cfg.rec.conv_width
    xr = matmul(x, p["w_in_x"])
    g = matmul(x, p["w_in_g"])
    prefix = torch.zeros((b, cw - 1, xr.shape[-1]), dtype=xr.dtype, device=xr.device)
    a, gx = _gates(p, _causal_conv(xr, p["conv"], prefix))
    h = _scan(a, gx, impl)
    out = matmul(h.to(x.dtype) * activation_fn("gelu")(g), p["w_out"])
    return (out, {"h": h[:, -1], "conv": xr[:, -(cw - 1):]}) if return_state else out


def rglru_init_state(cfg: ModelConfig, n_layers: int, batch: int, device) -> Dict:
    dr, cw = cfg.rec.d_rnn, cfg.rec.conv_width
    return {
        "h": torch.zeros((n_layers, batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cw - 1, dr), dtype=dtype_of(cfg), device=device),
    }


def rglru_decode_step(
    p: Dict, x: torch.Tensor, h: torch.Tensor, conv_state: torch.Tensor, cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token.  x: (B,1,d); h: (B,dr); conv_state: (B,cw-1,dr).
    Returns (out, new h, new conv state)."""
    xr = matmul(x, p["w_in_x"])
    g = matmul(x, p["w_in_g"])
    xr_conv = _causal_conv(xr, p["conv"], conv_state)
    new_conv = torch.cat([conv_state, xr], dim=1)[:, 1:]
    a, gx = _gates(p, xr_conv)
    h_new = a[:, 0] * h + gx[:, 0]
    y = h_new[:, None, :].to(x.dtype) * activation_fn("gelu")(g)
    return matmul(y, p["w_out"]), h_new, new_conv
