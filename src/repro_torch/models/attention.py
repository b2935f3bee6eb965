# Port of repro/models/attention.py.  What differs:
# * impl="kernel" is the counterpart of JAX's impl="pallas": it routes the
#   full-sequence path to the hand-written CUDA flash-attention kernel
#   (kernels/flash_attention; its plain version on a CPU tensor).
#   impl="chunked" (_attention_chunked) is plain torch, as in JAX, where it
#   runs outside Pallas: lax.scan over the kv chunks is a Python loop.
# * attention_decode writes the new token's K/V into the cache tensors in
#   place (JAX returns updated copies; a copy of a 428 MB cache per layer
#   and token is what in place saves) and returns the same tensors.  The
#   position ``t`` may be a 0-d tensor on the device, so a decode step
#   never waits on the host.
# * The scaled scores are f32 products of the rounded einsum and the scale
#   rounded to the model's dtype (_scaled), as XLA compiles JAX's
#   bfloat16 `einsum * scale` followed by a cast to f32.
# * init_kv_cache takes a device ("cuda" by default, resolved by
#   device.resolve_device).
# * with_logical is gone (a no-op on one card); attn_specs and
#   kv_cache_specs are left out (sharding only).
"""GQA attention: train/prefill (full-sequence) and decode (KV cache) paths.

Supports causal and local-window (RecurrentGemma) masking.  The
full-sequence path can route through the flash-attention kernel
(``impl="kernel"``); the einsum reference is the default and the oracle.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from .config import ModelConfig
from .layers import _in_dtype, apply_rope, dtype_of, einsum, matmul, normal_init, rope_angles

NEG_INF = -1e30


def attn_params(cfg: ModelConfig, gen: torch.Generator, n: int) -> Dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    s = d ** -0.5
    so = (hq * dh) ** -0.5
    return {
        "wq": normal_init(gen, (n, d, hq * dh), s, dt),
        "wk": normal_init(gen, (n, d, hkv * dh), s, dt),
        "wv": normal_init(gen, (n, d, hkv * dh), s, dt),
        "wo": normal_init(gen, (n, hq * dh, d), so, dt),
    }


def _split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, d_head)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D) for GQA."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def _mask_bias(seq_q: int, seq_k: int, offset: int, window: Optional[int],
               dtype: torch.dtype, device) -> torch.Tensor:
    """(seq_q, seq_k) additive mask; q position i attends k position j iff
    j <= i+offset and (window is None or j > i+offset-window)."""
    qpos = torch.arange(seq_q, device=device)[:, None] + offset
    kpos = torch.arange(seq_k, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def _scaled(scores: torch.Tensor, d_head: int) -> torch.Tensor:
    """``scores * d_head**-0.5`` as f32, the way compiled XLA computes JAX's
    ``(einsum(...) * scale).astype(f32)``: the Python scale takes the scores'
    dtype, and the product keeps f32 (excess precision skips its rounding
    to the scores' dtype)."""
    return scores.float() * _in_dtype(d_head ** -0.5, scores.dtype)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention_full(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    window: Optional[int] = None,
    impl: str = "reference",
) -> torch.Tensor:
    """Full-sequence causal attention.  x: (B, S, d); positions: (S,)."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(matmul(x, p["wq"]), hq, dh)
    k = _split_heads(matmul(x, p["wk"]), hkv, dh)
    v = _split_heads(matmul(x, p["wv"]), hkv, dh)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if impl == "kernel":
        from ..kernels.flash_attention.ops import flash_attention

        out = flash_attention(q, _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv),
                              causal=True, window=window)
    elif impl == "chunked":
        out = _attention_chunked(q, _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv),
                                 window=window)
    elif impl == "reference":
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
        scores = _scaled(einsum("bqhd,bkhd->bhqk", q, k), dh)
        bias = _mask_bias(q.shape[1], k.shape[1], 0, window, torch.float32, x.device)
        probs = _softmax(scores + bias).to(q.dtype)
        out = einsum("bhqk,bkhd->bqhd", probs, v)
    else:
        raise ValueError(f"unknown attention impl {impl!r}; use 'reference', 'chunked' "
                         "or 'kernel'")

    out = out.reshape(x.shape[0], x.shape[1], hq * dh)
    return matmul(out, p["wo"])


def _attention_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, window: Optional[int] = None, chunk: int = 512,
) -> torch.Tensor:
    """Flash-style causal attention as a loop over KV chunks.

    Never materializes the (S x S) score matrix — per step only a
    (B, H, S, chunk) tile exists.  The same online-softmax recurrence as the
    flash-attention kernel, in f32: ``-1e30`` masking, ``p`` zeroed where
    masked, ``l`` clamped at 1e-30.  q, k, v: (B, S, H, D).
    """
    b, s, h, d = q.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    scale = d ** -0.5
    qf = q.float() * scale
    kc = k.float().reshape(b, s // c, c, h, d)
    vc = v.float().reshape(b, s // c, c, h, d)
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for ik in range(s // c):
        kpos = ik * c + torch.arange(c, device=q.device)
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kc[:, ik])
        ok = kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok &= kpos[None, :] > qpos[:, None] - window
        sc = torch.where(ok[None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(ok[None, None], p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc[:, ik])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  window: Optional[int] = None, device="cuda") -> Dict:
    device = resolve_device(device)
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    length = min(max_len, window) if window else max_len
    dt = dtype_of(cfg)
    return {
        "k": torch.zeros((n_layers, batch, length, hkv, dh), dtype=dt, device=device),
        "v": torch.zeros((n_layers, batch, length, hkv, dh), dtype=dt, device=device),
    }


def attention_decode(
    p: Dict,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cfg: ModelConfig,
    t: torch.Tensor,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (B, 1, d); cache: (B, L, Hkv, dh), written in
    place; t: 0-d integer tensor, the position of the new token.  Returns
    (y, cache_k, cache_v).

    With a window, the cache is a rolling buffer of size W and the slot is
    t mod W; otherwise the cache is absolute-addressed.
    """
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    length = cache_k.shape[1]
    q = _split_heads(matmul(x, p["wq"]), hq, dh)
    k = _split_heads(matmul(x, p["wk"]), hkv, dh)
    v = _split_heads(matmul(x, p["wv"]), hkv, dh)
    cos, sin = rope_angles(t.reshape(1), dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    slot = (t % length) if window else t
    # dynamic_update_slice clamps the start into range; so does this
    slot = slot.reshape(1).long().clamp(0, length - 1)
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)

    kk = _repeat_kv(cache_k, hq // hkv)
    vv = _repeat_kv(cache_v, hq // hkv)
    scores = _scaled(einsum("bqhd,bkhd->bhqk", q, kk), dh)  # (B, H, 1, L)
    kpos = torch.arange(length, device=x.device)
    if window:
        valid = (kpos <= t % length) | (t >= length)  # rolling buffer: all valid once full
    else:
        valid = kpos <= t
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    probs = _softmax(scores.float() + bias[None, None, None, :])
    out = einsum("bhqk,bkhd->bqhd", probs.to(x.dtype), vv)
    out = out.reshape(b, 1, hq * dh)
    return matmul(out, p["wo"]), cache_k, cache_v
