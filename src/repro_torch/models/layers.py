# Port of repro/models/layers.py.  What differs:
# * dtype_of gives a torch dtype; normal_init draws from an explicit
#   torch.Generator on the target device (JAX keys have no torch
#   counterpart: the same seed gives other numbers, so tests that need
#   JAX's weights convert them with convert.params_from_jax).
# * activation_fn("silu") is written op by op, h * (1 / (1 + exp(-h))): XLA
#   lowers a bfloat16 logistic that way and rounds to bfloat16 after every
#   op, and F.silu, which rounds once, differs from it in about a third of
#   the elements of a bfloat16 MLP.  activation_fn("gelu") likewise writes
#   jax.nn.gelu's tanh form op by op with its constants in the input's
#   dtype (F.gelu rounds once and keeps its constants in f32).
# * A bfloat16 product on the CPU runs as an f32 product of the upcast
#   operands, rounded once (matmul, einsum): that is how XLA's CPU backend
#   computes it, and torch's own bfloat16 CPU kernels sum in another order.
#   On the card it runs in bfloat16 with f32 accumulation (cuBLAS).
# * rope_angles computes the frequencies and cos/sin in float64 and rounds
#   them to f32 (XLA compiles 1/theta**e as theta**-e, and its f32 pow, cos
#   and sin are within one ulp of the correctly rounded values).
# * with_logical returns a plain tensor as it is; it constrains only a
#   DTensor (the dry-run's meshes).
"""Shared layers: norms, rotary embedding, MLPs, initializers."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..distributed.sharding import with_logical
from .config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def normal_init(gen: torch.Generator, shape: Sequence[int], scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """Standard normal in f32 on ``gen``'s device, times ``scale``, cast.
    The scaling is in place, so a leaf's f32 draw is its only temporary."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(scale).to(dtype)


def _upcast(x: torch.Tensor) -> bool:
    return x.dtype == torch.bfloat16 and x.device.type == "cpu"


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation, rounded once to ``a``'s dtype."""
    if _upcast(a):
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand ``torch.einsum`` with f32 accumulation, rounded once to
    ``a``'s dtype."""
    if _upcast(a):
        return torch.einsum(eq, a.float(), b.float()).to(a.dtype)
    return torch.einsum(eq, a, b)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float,
             width: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over the last dim; ``width``, where the last dim holds
    padded zero heads beyond it (models/padding.py), is the real width the
    sum of squares is divided by."""
    dt = x.dtype
    x = x.float()
    if width is None or width == x.shape[-1]:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        var = torch.sum(x * x, dim=-1, keepdim=True) / width
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(dt)


def _silu(x: torch.Tensor) -> torch.Tensor:
    # XLA's logistic, one rounding per op: negate, exp, add, divide
    return x * (1 / (1 + torch.exp(-x)))


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``, as JAX casts it to the array's."""
    return float(torch.tensor(value, dtype=dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default, the tanh form, one rounding per op as XLA
    # computes it, with the constants rounded to x's dtype
    c = _in_dtype((2 / math.pi) ** 0.5, x.dtype)
    k = _in_dtype(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def activation_fn(name: str):
    if name == "silu":
        return _silu
    if name == "gelu":
        return _gelu
    if name == "relu2":  # Nemotron-4 squared ReLU
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(f"unknown activation {name}")


# ------------------------------------------------------------------ rotary
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim/2), f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # XLA's f32 pow and cos/sin are within one ulp of the correctly rounded
    # value; so, nearly always, are these float64 results rounded to f32
    freqs = (theta ** -exps.double()).float()
    ang = positions[..., None].float() * freqs
    return torch.cos(ang.double()).float(), torch.sin(ang.double()).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) or broadcastable.  Computed in
    f32 (x promotes against the f32 angles) and rounded once to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- MLP
def mlp_params(cfg: ModelConfig, gen: torch.Generator, n: int,
               d_ff: Optional[int] = None) -> Dict:
    """Stacked gated-MLP params for ``n`` layers."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    scale_in = d ** -0.5
    scale_out = ff ** -0.5
    return {
        "w_gate": normal_init(gen, (n, d, ff), scale_in, dt),
        "w_up": normal_init(gen, (n, d, ff), scale_in, dt),
        "w_down": normal_init(gen, (n, ff, d), scale_out, dt),
    }


def mlp_specs() -> Dict:
    return {
        "w_gate": (None, "fsdp", "ff"),
        "w_up": (None, "fsdp", "ff"),
        "w_down": (None, "ff", "fsdp"),
    }


def mlp_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); p holds one layer's weights."""
    act = activation_fn(cfg.activation)
    h = matmul(x, p["w_gate"])
    u = matmul(x, p["w_up"])
    h = with_logical(act(h) * u, "batch", None, "ff")
    return with_logical(matmul(h, p["w_down"]), "batch", "seq", None)
