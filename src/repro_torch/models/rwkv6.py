# Port of repro/models/rwkv6.py.  What differs:
# * impl="kernel" is the counterpart of JAX's impl="pallas": the scan goes
#   to the hand-written CUDA kernel (kernels/rwkv6_scan; its plain version
#   on a CPU tensor).  impl="chunked" (_rwkv_chunked, rwkv_chunked_bhtd) is
#   plain torch, as in JAX: the bfloat16 products with f32 accumulation are
#   f32 products of operands rounded to bfloat16 (exact products, f32
#   sums; cuBLAS on the card), and lax.scan over the chunks is a Python
#   loop.  An impl name the port does not know raises ValueError.
# * impl="reference" runs the kernel's plain version (the JAX step loop as
#   a loop over the tokens, kernels/rwkv6_scan/ref.py) where JAX runs its
#   own lax.scan of the same steps.
# * rwkv_params draws from a torch.Generator (other numbers than JAX's
#   keys; tests convert JAX's weights with convert.params_from_jax);
#   rwkv_init_state takes a device.
# * rwkv_decode_step returns new tensors, as JAX does; the transformer's
#   decode_step copies them into the cache in place.
# * rwkv_scan_full(..., return_state=True) also returns the decode cache's
#   leaves (S from the scan, or the state the chunk loop carries out, and
#   x_last), which the JAX prefill recomputes (transformer._rwkv_state_after).
# * with_logical is gone (a no-op on one card); rwkv_specs and
#   rwkv_state_specs are left out (sharding only).
"""RWKV-6 "Finch" time-mix block (arXiv:2404.05892), attention-free.

State: one matrix S in R^{dh x dh} per head.  Recurrence per token t:

    S_t = diag(w_t) . S_{t-1} + k_t^T v_t            (data-dependent decay)
    y_t = r_t . (diag(u) . k_t^T v_t + S_{t-1})

with w_t = exp(-exp(decay_t)) computed from the token (the "dynamic decay"
that distinguishes v6 from v5).  ``repro_torch.kernels.rwkv6_scan`` holds
the kernel and its step-by-step plain version; ``impl="chunked"`` is the
chunked formulation (parallel within a chunk, sequential across chunks).

Token-shift mixing (lerp between x_t and x_{t-1}) follows the RWKV design;
the low-rank "data-dependent lerp" (ddlerp) uses a single small MLP per
projection for clarity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import ModelConfig
from .layers import activation_fn, dtype_of, matmul, normal_init, rms_norm


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv.head_dim


def rwkv_params(cfg: ModelConfig, gen: torch.Generator, n: int) -> Dict:
    d = cfg.d_model
    dh = cfg.rwkv.head_dim
    H = _n_heads(cfg)
    dt = dtype_of(cfg)
    s = d ** -0.5
    lora = max(32, d // 32)
    f32 = torch.float32
    return {
        "mix_lerp": torch.zeros((n, 5, d), dtype=dt, device=gen.device),  # r,k,v,w,g lerps
        "w_r": normal_init(gen, (n, d, d), s, dt),
        "w_k": normal_init(gen, (n, d, d), s, dt),
        "w_v": normal_init(gen, (n, d, d), s, dt),
        "w_g": normal_init(gen, (n, d, d), s, dt),
        "w_o": normal_init(gen, (n, d, d), s, dt),
        # dynamic decay: d -> lora -> d
        "wd_a": normal_init(gen, (n, d, lora), s, dt),
        "wd_b": normal_init(gen, (n, lora, d), lora ** -0.5, dt),
        "decay_base": torch.full((n, d), -6.0, dtype=f32, device=gen.device)
        + normal_init(gen, (n, d), 0.3, f32),
        "bonus_u": normal_init(gen, (n, H, dh), 0.3, f32),
        "ln_x": torch.zeros((n, d), dtype=dt, device=gen.device),  # per-head group-norm gain
    }


def _projections(p: Dict, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig):
    """Token-shift lerped projections.  x: (B, S, d); x_prev: (B, S, d) is x
    shifted right by one token (decode passes the cached last token)."""
    lerp = p["mix_lerp"]  # (5, d)

    def mix(i):
        return x + (x_prev - x) * lerp[i][None, None, :]

    r = matmul(mix(0), p["w_r"])
    k = matmul(mix(1), p["w_k"])
    v = matmul(mix(2), p["w_v"])
    dec_in = mix(3)
    g = matmul(mix(4), p["w_g"])
    # dynamic decay (f32 for stability): w = exp(-exp(base + lora(x)))
    dd = matmul(dec_in, p["wd_a"])
    dd = matmul(torch.tanh(dd), p["wd_b"])
    logdecay = p["decay_base"][None, None, :] + dd.float()
    w = torch.exp(-torch.exp(logdecay))  # in (0, 1)
    return r, k, v, w, g


def _head_split(x: torch.Tensor, H: int, dh: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, H, dh)


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """x shifted one token later along the sequence, a zero row first
    (jnp.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1])."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rwkv_scan_full(
    p: Dict, x: torch.Tensor, cfg: ModelConfig, impl: str = "reference",
    return_state: bool = False,
):
    """Full-sequence RWKV-6.  x: (B, S, d) -> (B, S, d); with ``return_state``
    also the decode cache's leaves after the sequence, {"S": the scan's final
    state (B, H, dh, dh) f32, "x_last": x[:, -1]}."""
    H, dh = _n_heads(cfg), cfg.rwkv.head_dim
    b, s, d = x.shape
    r, k, v, w, g = _projections(p, x, _shift_right(x), cfg)
    r = _head_split(r, H, dh).float()
    k = _head_split(k, H, dh).float()
    v = _head_split(v, H, dh).float()
    w = _head_split(w, H, dh)

    if impl == "kernel":
        from ..kernels.rwkv6_scan.ops import rwkv6_scan

        out = rwkv6_scan(r, k, v, w, p["bonus_u"], return_state=return_state)
        y, S = out if return_state else (out, None)
    elif impl == "reference":
        from ..kernels.rwkv6_scan.ref import rwkv6_reference

        y, S = rwkv6_reference(*(a.transpose(1, 2) for a in (r, k, v, w)), p["bonus_u"],
                               return_state=True)
        y = y.transpose(1, 2)
    elif impl == "chunked":
        y, S = _rwkv_chunked(r, k, v, w, p["bonus_u"], return_state=True)
    else:
        raise ValueError(f"unknown rwkv impl {impl!r}; use 'reference', 'kernel' or 'chunked'")

    y = y.reshape(b, s, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps)     # group-norm stand-in
    y = y * activation_fn("silu")(g)
    out = matmul(y, p["w_o"])
    return (out, {"S": S, "x_last": x[:, -1]}) if return_state else out


def _bf16_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of ``a`` and ``b`` rounded to bfloat16, accumulated in f32
    (JAX's bfloat16 einsum with preferred_element_type=f32)."""
    return torch.einsum(eq, a.bfloat16().float(), b.bfloat16().float())


def _clamp(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -30.0, 30.0)


def _rwkv_chunked(r, k, v, w, u, chunk: int = 128, return_state: bool = False):
    """Chunked RWKV-6 on (B, S, H, D): :func:`rwkv_chunked_bhtd` on the
    transposed views, so the same math.  (JAX writes this layout out on its
    own to spare XLA the transposes' copies; torch's products and reshapes
    take the strided views as they are.)

    The model's decay parameterization (w = exp(-exp(-6 +- 1.3)) >= 0.99 per
    step) keeps in-chunk log-decay sums far from the clamp bound at 128.
    With ``return_state`` also returns the state S after the last chunk.
    """
    y, S = rwkv_chunked_bhtd(*(x.transpose(1, 2) for x in (r, k, v, w)), u, chunk=chunk,
                             return_state=True)
    y = y.transpose(1, 2)
    return (y, S) if return_state else y


def rwkv_chunked_bhtd(r, k, v, w, u, chunk: int = 64, return_state: bool = False):
    """Chunked RWKV-6: matmul form inside chunks, state carried across.

    Within a chunk of C tokens, with per-dim log-decays L_t = sum_{s<=t} ln w_s:
        y_t = (r_t . e^{L_{t-1}}) S_in
            + sum_{s<t} <r_t . e^{L_{t-1}-L_s}, k_s> v_s + <r_t . u, k_t> v_t
        S_out = diag(e^{L_C}) S_in + sum_s (k_s . e^{L_C-L_s})^T v_s
    so the intra-chunk part is one masked (C x C) product per head, and the
    state is read once per chunk instead of once per token.  Exponent
    differences are clamped at +-30: heavier-decayed terms are below f32
    resolution of the survivors anyway.  Inputs (B, H, T, D); with
    ``return_state`` also returns the state S after the last chunk.
    """
    b, h, t, dh = r.shape
    c = min(chunk, t)
    assert t % c == 0
    nc = t // c
    logw = torch.log(torch.clamp(w.float(), min=1e-30))
    rc = r.reshape(b, h, nc, c, dh)
    kc = k.reshape(b, h, nc, c, dh)
    vc = v.reshape(b, h, nc, c, dh)
    lw = logw.reshape(b, h, nc, c, dh)
    L = torch.cumsum(lw, dim=3)                 # L_t (inclusive)
    L_prev = L - lw                             # L_{t-1}
    L_end = L[:, :, :, -1:, :]                  # L_C
    r_hat = rc * torch.exp(_clamp(L_prev))      # r_t e^{L_{t-1}}
    k_hat = kc * torch.exp(_clamp(-L))          # k_s e^{-L_s}
    k_end = kc * torch.exp(_clamp(L_end - L))   # k_s e^{L_C - L_s}

    # the big products take bfloat16 operands with f32 accumulation; the
    # exponent math above stays f32
    A = _bf16_product("bhncd,bhnsd->bhncs", r_hat, k_hat)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    A = torch.where(mask[None, None, None], A, 0.0)
    diag = torch.einsum("bhncd,bhncd->bhnc", rc * u[None, :, None, None, :], kc)
    y_intra = _bf16_product("bhncs,bhnsv->bhncv", A, vc) + diag[..., None] * vc
    S_contrib = _bf16_product("bhnsd,bhnsv->bhndv", k_end, vc)

    S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    y_inter = []
    for n in range(nc):
        y_inter.append(torch.einsum("bhcd,bhdv->bhcv", r_hat[:, :, n], S))
        S = torch.exp(_clamp(L_end[:, :, n, 0]))[..., :, None] * S + S_contrib[:, :, n]
    y = (y_intra + torch.stack(y_inter, dim=2)).reshape(b, h, t, dh)
    return (y, S) if return_state else y


def rwkv_init_state(cfg: ModelConfig, n_layers: int, batch: int, device) -> Dict:
    H, dh = _n_heads(cfg), cfg.rwkv.head_dim
    return {
        "S": torch.zeros((n_layers, batch, H, dh, dh), dtype=torch.float32, device=device),
        "x_last": torch.zeros((n_layers, batch, cfg.d_model), dtype=dtype_of(cfg),
                              device=device),
    }


def rwkv_decode_step(
    p: Dict, x: torch.Tensor, S: torch.Tensor, x_last: torch.Tensor, cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token.  x: (B, 1, d); S: (B, H, dh, dh); x_last: (B, d).
    Returns (out, new S, new x_last)."""
    H, dh = _n_heads(cfg), cfg.rwkv.head_dim
    b, _, d = x.shape
    r, k, v, w, g = _projections(p, x, x_last[:, None, :], cfg)
    rt = _head_split(r, H, dh)[:, 0].float()
    kt = _head_split(k, H, dh)[:, 0].float()
    vt = _head_split(v, H, dh)[:, 0].float()
    wt = _head_split(w, H, dh)[:, 0]
    kv = kt[..., :, None] * vt[..., None, :]
    att = S + p["bonus_u"][None, :, :, None] * kv
    y = torch.einsum("bhk,bhkv->bhv", rt, att)
    S_new = wt[..., :, None] * S + kv
    y = y.reshape(b, 1, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * activation_fn("silu")(g)
    return matmul(y, p["w_o"]), S_new, x[:, 0]
