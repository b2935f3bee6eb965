# Port of repro/models/transformer.py: the dense and MoE paths and the
# layer kinds "rec" (RG-LRU, RecurrentGemma) and "rwkv" (RWKV-6).  What
# differs:
# * param_specs and cache_specs are left out (sharding; ROADMAP, module
#   item 10).
# * lax.scan over stacked layer parameters is a Python loop over index i of
#   the same stacked (n, ...) tensors, so a JAX parameter tree converts leaf
#   for leaf (convert.params_from_jax).  remat has no counterpart: autograd
#   keeps the activations (the models it trains here are small).
# * init_params and init_cache take a torch.Generator / a device
#   (init_cache's default is "cuda", resolved by device.resolve_device).
# * decode_step updates the cache in place: attention writes the new
#   token's K/V (see attention_decode), and the recurrent kinds copy their
#   new state into the cache's tensors.  The position "t" stays a 0-d int32
#   tensor on the device.
# * prefill stacks the per-layer caches over whatever leaves each kind
#   produces (k, v; h, conv; S, x_last).  The recurrent leaves come from
#   the layer's own scan (rglru_full / rwkv_scan_full with return_state:
#   the kernel's final state, or its plain version's on a CPU tensor or
#   under impl="reference"), where JAX recomputes them after the layer
#   (_rec_state_after, a second associative_scan; _rwkv_state_after, a
#   second lax.scan).  The leaves hold the same values as JAX's, to the
#   order of f32 sums.
# * An embedding lookup of an id outside [-V, V) gives NaN rows and a
#   negative id in range counts from the end, as jnp.take does.
# * The second norm of a layer reads the residual sum after the mixer
#   unrounded, in f32 (_mlp_half), as XLA's compiled scan body does; the
#   MoE layer (moe_apply) reads the same normed input as the MLP.
# * with_logical is gone (a no-op on one card).
"""LM assembly: embed -> layer loop -> logits.

Per layer kind:

  attn  — GQA attention (optionally local-window) + gated MLP (or MoE)
  rec   — RG-LRU recurrence + gated MLP
  rwkv  — RWKV-6 time-mix + gated MLP (channel-mix swapped for SwiGLU of the
          same width; parameter-count equivalent)

each as RMSNorm -> mixer -> residual -> RMSNorm -> MLP -> residual.

Entry points: ``init_params`` / ``forward`` / ``loss_and_aux`` / ``prefill`` /
``init_cache`` / ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from .attention import (
    _split_heads,
    attention_decode,
    attention_full,
    attn_params,
    init_kv_cache,
)
from .config import ModelConfig
from .layers import (
    apply_rope,
    dtype_of,
    matmul,
    mlp_apply,
    mlp_params,
    normal_init,
    rms_norm,
    rope_angles,
)
from .moe import moe_apply, moe_params
from .rglru import (
    rglru_decode_step,
    rglru_full,
    rglru_init_state,
    rglru_params,
)
from .rwkv6 import (
    rwkv_decode_step,
    rwkv_init_state,
    rwkv_params,
    rwkv_scan_full,
)

Params = Dict[str, Any]


def _layer_uses_moe(cfg: ModelConfig, kind: str) -> bool:
    return cfg.moe is not None and kind == "attn"


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in ("attn", "rec", "rwkv"):
        raise ValueError(kind)


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree of stacked (n, ...) tensors (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------- params
def _sublayer_params(cfg: ModelConfig, kind: str, gen: torch.Generator, n: int) -> Dict:
    _check_kind(cfg, kind)
    dt = dtype_of(cfg)
    mixer = {"attn": attn_params, "rec": rglru_params, "rwkv": rwkv_params}[kind]
    p = {
        "norm1": torch.zeros((n, cfg.d_model), dtype=dt, device=gen.device),
        "norm2": torch.zeros((n, cfg.d_model), dtype=dt, device=gen.device),
        kind: mixer(cfg, gen, n),
    }
    if _layer_uses_moe(cfg, kind):
        p["moe"] = moe_params(cfg, gen, n)
    else:
        p["mlp"] = mlp_params(cfg, gen, n)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights on ``gen``'s device, in the JAX package's tree layout."""
    dt = dtype_of(cfg)
    params: Params = {
        "embed": normal_init(gen, (cfg.vocab, cfg.d_model), 1.0, dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dt)
    for gi, (pattern, rep) in enumerate(cfg.groups):
        params[f"group{gi}"] = {
            f"pos{pi}": _sublayer_params(cfg, kind, gen, rep)
            for pi, kind in enumerate(pattern)
        }
    return params


# ------------------------------------------------------------------ forward
def _apply_sublayer(
    cfg: ModelConfig, kind: str, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
    impl: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kind(cfg, kind)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if kind == "attn":
        h = attention_full(lp["attn"], h, cfg, positions, window=cfg.attn_window, impl=impl)
    elif kind == "rec":
        h = rglru_full(lp["rec"], h, cfg, impl=impl)
    else:
        h = rwkv_scan_full(lp["rwkv"], h, cfg, impl=impl)
    return _mlp_half(cfg, lp, x, h)


def _mlp_half(cfg: ModelConfig, lp: Dict, x: torch.Tensor, y: torch.Tensor,
              decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + y, then the second norm and the MLP (or the MoE layer, dense
    when ``decode``), then the second residual.  Returns it and the MoE aux
    loss (0.0 for an MLP).

    Compiled XLA (excess precision allowed, its default) hands the second
    norm the sum ``x + y`` unrounded, in f32, while the residual stream
    takes it rounded to the model's dtype.  The port computes it the same
    way; in f32 nothing changes.
    """
    s = x.float() + y.float()
    h = rms_norm(s, lp["norm2"], cfg.norm_eps).to(x.dtype)
    if "moe" in lp:
        out, aux = moe_apply(lp["moe"], h, cfg, decode=decode)
    else:
        out, aux = mlp_apply(lp["mlp"], h, cfg), 0.0
    return s.to(x.dtype) + out, aux


def _run_groups(
    cfg: ModelConfig, params: Params, x: torch.Tensor, positions: torch.Tensor, impl: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (pattern, rep) in enumerate(cfg.groups):
        gparams = params[f"group{gi}"]
        for i in range(rep):
            layer_params = _layer(gparams, i)
            for pi, kind in enumerate(pattern):
                x, aux = _apply_sublayer(cfg, kind, layer_params[f"pos{pi}"], x, positions,
                                         impl)
                aux_total = aux_total + aux
    return x, aux_total


def _take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """jnp.take(table, ids, axis=0): ids in [-V, 0) count from the end, ids
    outside [-V, V) give NaN rows."""
    v = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    ok = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, v - 1)]
    return torch.where(ok[..., None], rows, torch.full((), float("nan"), dtype=table.dtype,
                                                         device=table.device))


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           patches: Optional[torch.Tensor]) -> torch.Tensor:
    x = _take_rows(params["embed"], tokens)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return matmul(x, params["embed"].t())
    return matmul(x, params["unembed"])


def forward(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor,
    patches: Optional[torch.Tensor] = None, impl: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S_text); patches: (B, P, d) or None.
    Returns (logits (B, S_total, V), aux_loss)."""
    x = _embed(cfg, params, tokens, patches)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux = _run_groups(cfg, params, x, positions, impl)
    return _logits(cfg, params, x), aux


def loss_and_aux(
    cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
    impl: str = "reference",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (f32), z-loss, MoE aux.  ``batch["tokens"]``:
    (B, S_text); optional ``batch["patches"]``: (B, P, d)."""
    tokens = batch["tokens"]
    patches = batch.get("patches")
    inputs = tokens[:, :-1]
    labels = tokens[:, 1:]
    logits, aux = forward(cfg, params, inputs, patches, impl)
    # predictions for text labels sit at the last (S_text - 1) positions
    logits = logits[:, -labels.shape[1]:, :].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold).mean()
    z_loss = 1e-4 * (logz ** 2).mean()
    total = nll + z_loss + 0.01 * aux
    return total, {"nll": nll, "z_loss": z_loss, "moe_aux": aux}


# -------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Dict:
    device = resolve_device(device)
    cache: Dict[str, Any] = {"t": torch.zeros((), dtype=torch.int32, device=device)}
    for gi, (pattern, rep) in enumerate(cfg.groups):
        g: Dict[str, Any] = {}
        for pi, kind in enumerate(pattern):
            _check_kind(cfg, kind)
            if kind == "attn":
                g[f"pos{pi}"] = init_kv_cache(cfg, rep, batch, max_len,
                                              window=cfg.attn_window, device=device)
            elif kind == "rec":
                g[f"pos{pi}"] = rglru_init_state(cfg, rep, batch, device)
            else:
                g[f"pos{pi}"] = rwkv_init_state(cfg, rep, batch, device)
        cache[f"group{gi}"] = g
    return cache


def decode_step(
    cfg: ModelConfig, params: Params, token: torch.Tensor, cache: Dict,
) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1) int.  Returns (logits (B, 1, V), the cache updated in
    place (the new token's K/V, the recurrent states) and ``t`` advanced)."""
    t = cache["t"]
    x = _take_rows(params["embed"], token)
    new_cache: Dict[str, Any] = {"t": t + 1}
    for gi, (pattern, rep) in enumerate(cfg.groups):
        gparams = params[f"group{gi}"]
        gcache = cache[f"group{gi}"]
        for i in range(rep):
            layer_params = _layer(gparams, i)
            for pi, kind in enumerate(pattern):
                _check_kind(cfg, kind)
                lp = layer_params[f"pos{pi}"]
                lc = gcache[f"pos{pi}"]
                hin = rms_norm(x, lp["norm1"], cfg.norm_eps)
                if kind == "attn":
                    y, _, _ = attention_decode(lp["attn"], hin, lc["k"][i], lc["v"][i], cfg, t,
                                               window=cfg.attn_window)
                elif kind == "rec":
                    y, hh, conv = rglru_decode_step(lp["rec"], hin, lc["h"][i], lc["conv"][i],
                                                    cfg)
                    lc["h"][i].copy_(hh)
                    lc["conv"][i].copy_(conv)
                else:
                    y, S, x_last = rwkv_decode_step(lp["rwkv"], hin, lc["S"][i],
                                                    lc["x_last"][i], cfg)
                    lc["S"][i].copy_(S)
                    lc["x_last"][i].copy_(x_last)
                x, _ = _mlp_half(cfg, lp, x, y, decode=True)
        new_cache[f"group{gi}"] = gcache
    return _logits(cfg, params, x), new_cache


# ------------------------------------------------------------------- prefill
def prefill(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor,
    patches: Optional[torch.Tensor] = None, impl: str = "reference",
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence pass that also builds the decode cache: K/V
    re-projected per attention layer, as the JAX package does; each
    recurrent layer's final state taken from the layer's own scan.  Returns
    (last-token logits (B, V), cache)."""
    x = _embed(cfg, params, tokens, patches)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cache: Dict[str, Any] = {"t": torch.tensor(S, dtype=torch.int32, device=x.device)}

    for gi, (pattern, rep) in enumerate(cfg.groups):
        gparams = params[f"group{gi}"]
        per_layer = []
        for i in range(rep):
            layer_params = _layer(gparams, i)
            new_layer_cache = {}
            for pi, kind in enumerate(pattern):
                _check_kind(cfg, kind)
                lp = layer_params[f"pos{pi}"]
                hin = rms_norm(x, lp["norm1"], cfg.norm_eps)
                if kind == "attn":
                    y = attention_full(lp["attn"], hin, cfg, positions,
                                       window=cfg.attn_window, impl=impl)
                    new_layer_cache[f"pos{pi}"] = _kv_for_cache(cfg, lp["attn"], hin, positions)
                elif kind == "rec":
                    y, new_layer_cache[f"pos{pi}"] = rglru_full(lp["rec"], hin, cfg, impl=impl,
                                                                return_state=True)
                else:
                    y, new_layer_cache[f"pos{pi}"] = rwkv_scan_full(lp["rwkv"], hin, cfg,
                                                                    impl=impl, return_state=True)
                x, _ = _mlp_half(cfg, lp, x, y)
            per_layer.append(new_layer_cache)
        cache[f"group{gi}"] = {
            pos: {leaf: torch.stack([c[pos][leaf] for c in per_layer]) for leaf in leaves}
            for pos, leaves in per_layer[0].items()
        }
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits[:, 0, :], cache


def _kv_for_cache(cfg: ModelConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor) -> Dict:
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = _split_heads(matmul(x, p["wk"]), hkv, dh)
    v = _split_heads(matmul(x, p["wv"]), hkv, dh)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    k = apply_rope(k, cos, sin)
    if cfg.attn_window:
        k = k[:, -cfg.attn_window:]
        v = v[:, -cfg.attn_window:]
    return {"k": k, "v": v}

