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
# * with_logical returns a plain tensor as it is; it constrains only a
#   DTensor (the dry-run's meshes).  Decode constrains q on ("batch",
#   "heads") as the full path does (else DTensor leaves it a partial sum
#   over "data" and gathers the cache to meet it), keeps the heads a batch
#   dim of 4-D products, so a cache split over kv_heads or kv_seq is read
#   where it lies (on a plain tensor the same bmm as JAX's einsum, the same
#   bits), and writes a kv_seq-split cache with a masked select, as XLA
#   partitions its dynamic_update_slice.
# * The q head count is the weights' (_q_layout): on a mesh whose "model"
#   axis does not divide the heads, the dry-run places parameters padded
#   by models/padding.py (XLA pads the same heads inside its step).  The
#   repeated k and v get a zero head in each padded q slot, so a padded
#   head's output is exactly 0; decode drops the padded heads before its
#   products over the cache and puts them back as zeros after, and on a
#   plain tensor (one device) projects the real heads only.
# * A HybridConfig (Granite-4.0-H) scales the scores by its attn_scale and,
#   with rope False, takes no rotary embedding (attn_scale, uses_rope); every
#   other config keeps the head dim's inverse root and RoPE, bit for bit.
"""GQA attention: train/prefill (full-sequence) and decode (KV cache) paths.

Supports causal and local-window (RecurrentGemma) masking.  The
full-sequence path can route through the flash-attention kernel
(``impl="kernel"``); the einsum reference is the default and the oracle.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..distributed.sharding import (gathered, heads_merged, heads_split, is_dtensor, is_sharded,
                                    with_logical)
from .config import HybridConfig, ModelConfig
from .layers import _in_dtype, apply_rope, dtype_of, einsum, matmul, normal_init, rope_angles
from .padding import pad_heads, q_groups, unpad_heads

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


def attn_specs(cfg: ModelConfig, tp: int = 16) -> Dict:
    kv_sharded = cfg.n_kv_heads % tp == 0
    kv = "heads" if kv_sharded else None
    return {
        "wq": (None, "fsdp", "heads"),
        "wk": (None, "fsdp", kv),
        "wv": (None, "fsdp", kv),
        "wo": (None, "heads", "fsdp"),
    }


def _split_heads(x: torch.Tensor, n_heads: int, d_head: int, kv: bool = False) -> torch.Tensor:
    """The heads of a q (or, ``kv``, a k or v) projection; the kv heads are
    never padded, so a split of them that would cut a head is gathered."""
    return heads_split(x, n_heads, d_head, gather=kv)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D) for GQA."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def _q_layout(p: Dict, cfg: ModelConfig) -> Tuple[int, int, int]:
    """The q heads as the weights hold them (the config's, or padded to a
    mesh split): (groups, real heads per group, heads per group)."""
    return q_groups(cfg, p["wq"].shape[-1] // cfg.head_dim)


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


def attn_scale(cfg: ModelConfig) -> float:
    """The scores' scale: a HybridConfig's ``attn_scale``, else
    ``head_dim ** -0.5``."""
    if isinstance(cfg, HybridConfig) and cfg.attn_scale is not None:
        return cfg.attn_scale
    return cfg.head_dim ** -0.5


def uses_rope(cfg: ModelConfig) -> bool:
    """Whether q and k take the rotary embedding (a HybridConfig may say no)."""
    return not isinstance(cfg, HybridConfig) or cfg.rope


def _scaled(scores: torch.Tensor, scale: float) -> torch.Tensor:
    """``scores * scale`` as f32, the way compiled XLA computes JAX's
    ``(einsum(...) * scale).astype(f32)``: the Python scale takes the scores'
    dtype, and the product keeps f32 (excess precision skips its rounding
    to the scores' dtype)."""
    return scores.float() * _in_dtype(scale, scores.dtype)


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
    layout = _q_layout(p, cfg)
    n_q = layout[0] * layout[2]
    q = _split_heads(matmul(x, p["wq"]), n_q, dh)
    k = _split_heads(matmul(x, p["wk"]), hkv, dh, kv=True)
    v = _split_heads(matmul(x, p["wv"]), hkv, dh, kv=True)
    if uses_rope(cfg):
        cos, sin = rope_angles(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = with_logical(q, "batch", None, "heads", None)
    k = with_logical(k, "batch", None, "kv_heads" if hkv % 8 == 0 else None, None)
    # k and v repeated to q's heads (zero heads in q's padded slots) and
    # split as q is (XLA carries q's split onto them; DTensor would gather q
    # to meet a replicated k)
    k, v = (with_logical(pad_heads(_repeat_kv(t, hq // hkv), 2, *layout),
                         "batch", None, "heads", None) for t in (k, v))

    if impl == "kernel":
        from ..kernels.flash_attention.ops import flash_attention

        out = flash_attention(q, k, v, causal=True, window=window, scale=attn_scale(cfg))
    elif impl == "chunked":
        out = _attention_chunked(q, k, v, window=window, scale=attn_scale(cfg))
    elif impl == "reference":
        scores = _scaled(einsum("bqhd,bkhd->bhqk", q, k), attn_scale(cfg))
        bias = _mask_bias(q.shape[1], k.shape[1], 0, window, torch.float32, x.device)
        probs = _softmax(scores + bias).to(q.dtype)
        out = einsum("bhqk,bkhd->bqhd", probs, v)
    else:
        raise ValueError(f"unknown attention impl {impl!r}; use 'reference', 'chunked' "
                         "or 'kernel'")

    return with_logical(matmul(heads_merged(out), p["wo"]), "batch", "seq", None)


def _attention_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, window: Optional[int] = None, chunk: int = 512, scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style causal attention as a loop over KV chunks.

    Never materializes the (S x S) score matrix — per step only a
    (B, H, S, chunk) tile exists.  The same online-softmax recurrence as the
    flash-attention kernel, in f32: ``-1e30`` masking, ``p`` zeroed where
    masked, ``l`` clamped at 1e-30.  q, k, v: (B, S, H, D); the scores
    scaled by ``scale`` (default ``D ** -0.5``).
    """
    b, s, h, d = q.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    scale = d ** -0.5 if scale is None else scale
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


def kv_cache_specs(cfg: ModelConfig, tp: int = 16) -> Dict:
    if cfg.n_kv_heads % tp == 0:
        spec = (None, "batch", None, "kv_heads", None)
    else:
        spec = (None, "batch", "kv_seq", None, None)
    return {"k": spec, "v": spec}


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
    layout = _q_layout(p, cfg)
    b = x.shape[0]
    length = cache_k.shape[1]
    wq = p["wq"]
    if layout[1] != layout[2] and not is_dtensor(x):
        # padded heads on one device: project the real heads only (cuBLAS
        # splits a product of a few rows by its width, so the padded width
        # would round otherwise than the unpadded model)
        wq = unpad_heads(wq, -1, *layout)
    q = _split_heads(matmul(x, wq), wq.shape[-1] // dh, dh)
    k = _split_heads(matmul(x, p["wk"]), hkv, dh, kv=True)
    v = _split_heads(matmul(x, p["wv"]), hkv, dh, kv=True)
    if uses_rope(cfg):
        cos, sin = rope_angles(t.reshape(1), dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = with_logical(q, "batch", None, "heads", None)
    if q.shape[2] != hq:
        # padded heads on a mesh: the products over the cache take the real ones
        q = unpad_heads(gathered(q, 2), 2, *layout)

    slot = (t % length) if window else t
    # dynamic_update_slice clamps the start into range; so does this
    slot = slot.reshape(1).long().clamp(0, length - 1)
    if is_sharded(cache_k, 1):
        # a cache split over its sequence (kv_seq): each shard rewrites the
        # rows it holds, the slot's from the new token, as XLA partitions a
        # dynamic_update_slice on a sharded dim
        hit = (torch.arange(length, device=x.device) == slot)[None, :, None, None]
        cache_k.copy_(torch.where(hit, k, cache_k))
        cache_v.copy_(torch.where(hit, v, cache_v))
    else:
        cache_k.index_copy_(1, slot, k)
        cache_v.index_copy_(1, slot, v)

    kk = _repeat_kv(cache_k, hq // hkv)
    vv = _repeat_kv(cache_v, hq // hkv)
    # heads stay a batch dim of 4-D products (B, H, 1, D) @ (B, H, D, L): a
    # sharded cache is read where it lies
    scores = _scaled(matmul(q.transpose(1, 2), kk.permute(0, 2, 3, 1)),
                     attn_scale(cfg))  # (B, H, 1, L)
    kpos = torch.arange(length, device=x.device)
    if window:
        valid = (kpos <= t % length) | (t >= length)  # rolling buffer: all valid once full
    else:
        valid = kpos <= t
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    probs = _softmax(scores.float() + bias[None, None, None, :])
    out = matmul(probs.to(x.dtype), vv.transpose(1, 2)).transpose(1, 2)  # (B, 1, H, D)
    out = pad_heads(out, 2, *layout)
    out = out.reshape(b, 1, out.shape[2] * dh)
    return with_logical(matmul(out, p["wo"]), "batch", None, None), cache_k, cache_v
