# The port's own module: the JAX package has no counterpart, because XLA
# pads a head dim that a mesh axis does not divide inside the compiled step
# (a with_sharding_constraint on 40 heads over a 16-way "model" axis gives
# each device 3 heads, 8 of the 48 empty).  DTensor cannot split a dim
# unevenly, so the port pads the parameters instead, before they are
# placed, and the models read their head counts from the weights' shapes.
"""Heads padded to a mesh axis's split.

``pad_params(cfg, params, split)`` gives the same model with its head count
padded up to a multiple of ``split`` (40 -> 48 over 16, 24 -> 32), so that
every device of a ``split``-way "model" axis holds whole heads.  The padded
heads are zero columns of the head projections (attention's q; RWKV-6's r,
k, v, g and its decay LoRA's output) and zero rows of the output
projection, and each yields exactly 0 before that projection:

* attention: the kv heads are not padded (they are replicated over the
  axis where it does not divide them, as JAX's kv specs replicate them).
  Their repeat to the q heads (attention._repeat_kv) puts a zero head in
  each padded q slot, so a padded head's scores are 0, its softmax
  uniform, and the values it averages 0.  Under GQA each kv head's group
  of q heads is padded (Scout: 8 groups of 5 -> 6, 48), so real q head i
  still reads kv head i // 5; multi-head attention pads after the last
  head (24 -> 32).  Decode drops the padded heads before the products
  over the cache (unpad_heads) and restores them as zeros after.
* RWKV-6: a padded head's k and v are 0, so k^T v is 0 and its state S
  stays 0 from its zero start, and y = r (S + diag(u) k^T v) is 0 (its
  decay w = exp(-exp(0)) multiplies a zero state).  The output norm over
  the merged heads divides the sum of squares by the real width
  (``rms_norm(..., width=cfg.d_model)``), so the zeros change no mean.
  The decode state S is padded with zero heads too (pad_cache).

On one device (plain tensors) decode projects and steps the real heads
only: cuBLAS splits a product of a few rows by its width, so at the padded
width its sums would round otherwise than the unpadded model's (the
full-sequence products round alike, bit for bit on an H100).

The zero output rows make the layer's output that of the unpadded model, up
to the order of the projection's sums.  The config is left as it is, so
parameter counts and model FLOPs stay the unpadded model's.  With no
padding needed (``split`` divides the heads, or is 1) the trees come back
as they were.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig


def _round_up(n: int, split: int) -> int:
    return -(-n // split) * split


def attn_heads(cfg: ModelConfig, split: int) -> int:
    """An attention layer's q heads padded to ``split``: GQA pads each
    kv head's group to the smallest size that makes ``split`` divide the
    q heads (Scout: 8 groups of 5 -> 6, 48); multi-head attention pads
    after the last head (24 -> 32)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % split == 0:
        return hq
    if hq == hkv:
        return _round_up(hq, split)
    g = hq // hkv
    while (hkv * g) % split:
        g += 1
    return hkv * g


def q_groups(cfg: ModelConfig, n_heads: int) -> Tuple[int, int, int]:
    """The layout of ``n_heads`` q heads (the config's, or padded by
    :func:`attn_heads`) as (groups, real heads per group, heads per group):
    GQA's kv groups, or one group for multi-head attention."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq == hkv:
        return 1, hq, n_heads
    return hkv, hq // hkv, n_heads // hkv


def rwkv_heads(cfg: ModelConfig, split: int) -> int:
    """RWKV-6's head count padded to ``split``."""
    return _round_up(cfg.d_model // cfg.rwkv.head_dim, split)


def pad_heads(x: torch.Tensor, dim: int, groups: int, per: int, per_padded: int
              ) -> torch.Tensor:
    """``x`` with its ``dim`` read as ``groups`` groups of ``per`` heads (of
    any width), each group padded with zero heads to ``per_padded``."""
    if per_padded == per:
        return x
    dim %= x.ndim
    unit = x.shape[dim] // (groups * per)
    v = x.reshape(*x.shape[:dim], groups, per, unit, *x.shape[dim + 1:])
    # F.pad's pairs run from the last dim: unit's and the dims after it first
    v = F.pad(v, (0, 0) * (x.ndim - dim) + (0, per_padded - per))
    return v.reshape(*x.shape[:dim], groups * per_padded * unit, *x.shape[dim + 1:])


def unpad_heads(x: torch.Tensor, dim: int, groups: int, per: int, per_padded: int
                ) -> torch.Tensor:
    """The inverse of :func:`pad_heads`: the real heads of each group."""
    if per_padded == per:
        return x
    dim %= x.ndim
    unit = x.shape[dim] // (groups * per_padded)
    v = x.reshape(*x.shape[:dim], groups, per_padded, unit, *x.shape[dim + 1:])
    v = v.narrow(dim + 1, 0, per)
    return v.reshape(*x.shape[:dim], groups * per * unit, *x.shape[dim + 1:])


def _pad_attn(cfg: ModelConfig, p: Dict, split: int) -> Dict:
    layout = q_groups(cfg, attn_heads(cfg, split))
    if layout[1] == layout[2]:
        return p
    return {**p, "wq": pad_heads(p["wq"], -1, *layout), "wo": pad_heads(p["wo"], 1, *layout)}


_RWKV_COLUMNS = ("w_r", "w_k", "w_v", "w_g", "wd_b", "decay_base", "ln_x")


def _pad_rwkv(cfg: ModelConfig, p: Dict, split: int) -> Dict:
    layout = (1, cfg.d_model // cfg.rwkv.head_dim, rwkv_heads(cfg, split))
    if layout[1] == layout[2]:
        return p
    out = {**p, "w_o": pad_heads(p["w_o"], 1, *layout),
           "bonus_u": pad_heads(p["bonus_u"], 1, *layout)}
    for name in _RWKV_COLUMNS:
        out[name] = pad_heads(p[name], -1, *layout)
    return out


def unpad_rwkv(cfg: ModelConfig, p: Dict) -> Dict:
    """The inverse of :func:`_pad_rwkv` on one layer's parameters: the real
    heads' columns and rows (views: RWKV-6 pads after its last head)."""
    H = cfg.d_model // cfg.rwkv.head_dim
    layout = (1, H, p["w_r"].shape[-1] // cfg.rwkv.head_dim)
    out = {**p, "w_o": unpad_heads(p["w_o"], 0, *layout),
           "bonus_u": unpad_heads(p["bonus_u"], 0, *layout)}
    for name in _RWKV_COLUMNS:
        out[name] = unpad_heads(p[name], -1, *layout)
    return out


def _map_layers(cfg: ModelConfig, tree: Dict, fn) -> Dict:
    """``tree`` with fn(kind, subtree) applied to each layer position's
    subtree."""
    out = dict(tree)
    for gi, (pattern, _) in enumerate(cfg.groups):
        group = dict(tree[f"group{gi}"])
        for pi, kind in enumerate(pattern):
            group[f"pos{pi}"] = fn(kind, group[f"pos{pi}"])
        out[f"group{gi}"] = group
    return out


def pad_params(cfg: ModelConfig, params: Dict[str, Any], split: int) -> Dict[str, Any]:
    """``params`` (init_params' tree) with every mixer's heads padded to
    ``split``; leaves that hold no head dim are the same tensors."""
    def layer(kind, lp):
        if kind == "attn":
            return {**lp, "attn": _pad_attn(cfg, lp["attn"], split)}
        if kind == "rwkv":
            return {**lp, "rwkv": _pad_rwkv(cfg, lp["rwkv"], split)}
        return lp

    return _map_layers(cfg, params, layer)


def pad_cache(cfg: ModelConfig, cache: Dict[str, Any], split: int) -> Dict[str, Any]:
    """``cache`` (init_cache's tree) as the model padded by :func:`pad_params`
    holds it: RWKV-6's state S with zero heads (a KV cache holds the kv
    heads, which are not padded)."""
    def layer(kind, lc):
        if kind == "rwkv":
            layout = (1, cfg.d_model // cfg.rwkv.head_dim, rwkv_heads(cfg, split))
            return {**lc, "S": pad_heads(lc["S"], 2, *layout)}
        return lc

    return _map_layers(cfg, cache, layer)
