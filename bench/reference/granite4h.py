"""Plain float32 reference of IBM Granite-4.0-H (HF ``granitemoehybrid``
with no experts; arXiv:2405.21060 for the Mamba-2 mixer): the whole
sequence at once, no cache, no batching beyond the sessions given.

    x = embed[ids] * embedding_multiplier
    per layer: x = x + residual_multiplier * mixer(RMSNorm(x))
               x = x + residual_multiplier * mlp(RMSNorm(x))
    logits = RMSNorm(x) @ embed^T / logits_scaling

mixer is GQA attention with no position embedding and scores times
``attention_multiplier``, or Mamba-2:

    z, xBC, dt = x @ in_proj;  xBC = silu(causal depthwise conv(xBC))
    x, B, C = xBC;  dt = softplus(dt + dt_bias);  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) outer B_t;  y_t = h_t C_t + D x_t
    out = RMSNorm(y * silu(z)) @ out_proj

mlp is SwiGLU: (silu(x @ gate) * (x @ up)) @ down.

The configuration's keys are the published config.json's.  Departures
from the published description, all of layout or of cost, none of
arithmetic: weights are handed as (in, out) matrices, as ``x @ W`` takes
them (HF stores (out, in)), the conv's as (channels, taps); attention is
computed in blocks of query rows, so a 16k-token sequence fits; only the
last position's logits are formed unless all are asked for.  The scan
comes in two forms: ``sequential``, the recurrence token by token (the
definition), and ``chunked``, the state-space duality's closed form over
chunks (the sequence padded at its end with dt = 0, which leaves the state
as it is).  ``lowp`` is the control one precision below the program's
bfloat16: weights and each product's inputs rounded to float8 e4m3 with a
per-tensor scale, the scan's states to bfloat16.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

F = torch.nn.functional


def no_tf32() -> None:
    """Full float32 products on the card (TF32 keeps about three digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


no_tf32()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale, back in f32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _w(t: torch.Tensor, lowp: bool) -> torch.Tensor:
    return _fp8(t) if lowp else t.float()


def _mm(x: torch.Tensor, w: torch.Tensor, lowp: bool) -> torch.Tensor:
    return (_fp8(x) if lowp else x) @ _w(w, lowp)


def _state(h: torch.Tensor, lowp: bool) -> torch.Tensor:
    return h.bfloat16().float() if lowp else h


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def scan_sequential(x, dt, A, B, C, lowp: bool = False):
    """x (b, T, H, P), dt (b, T, H), A (H,), B and C (b, T, G, N), f32 ->
    y (b, T, H, P) without the D term, final state (b, H, P, N)."""
    b, T, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    h = torch.zeros(b, H, P, B.shape[3], dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]
        h = _state(decay * h + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :],
                   lowp)
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, 1), h


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., l) -> (..., l, l): sum of a[u+1 .. t] at (t, u) for u <= t,
    -inf above the diagonal."""
    l = a.shape[-1]
    rep = a[..., None].expand(*a.shape, l)                       # (..., l[t], l[u]) = a[t]
    below = torch.tril(torch.ones(l, l, dtype=torch.bool, device=a.device), -1)
    out = torch.cumsum(rep.masked_fill(~below, 0), dim=-2)
    keep = torch.tril(torch.ones(l, l, dtype=torch.bool, device=a.device))
    return out.masked_fill(~keep, -torch.inf)


def scan_chunked(x, dt, A, B, C, chunk: int, lowp: bool = False):
    """The closed form of :func:`scan_sequential` over chunks of ``chunk``
    tokens (the Mamba-2 paper's listing); same arguments and results."""
    b, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    pad = (-T) % chunk
    if pad:  # dt = 0 and x = 0: the state passes the padding unchanged
        x, dt, B, C = (F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad)) for t in (x, dt, B, C))
    c = x.shape[1] // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, H, P)
    a = (dt * A).reshape(b, c, chunk, H).permute(0, 3, 1, 2)          # (b, H, c, l)
    Bc = B.reshape(b, c, chunk, G, N).repeat_interleave(H // G, 3)    # (b, c, l, H, N)
    Cc = C.reshape(b, c, chunk, G, N).repeat_interleave(H // G, 3)
    acum = torch.cumsum(a, -1)
    L = torch.exp(_segsum(a))                                         # (b, H, c, l, l)
    scores = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc) * L
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, X)
    decay_states = torch.exp(acum[..., -1:] - acum)                   # (b, H, c, l)
    states = _state(torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, X), lowp)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)  # the zero initial state
    decay_chunk = torch.exp(_segsum(F.pad(acum[..., -1], (1, 0))))    # (b, H, c+1, c+1)
    states = _state(torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states), lowp)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states[:, :-1], torch.exp(acum))
    y = (y_diag + y_off).reshape(b, c * chunk, H, P)[:, :T]
    return y, states[:, -1]


def _mamba(cfg: Dict, p: Dict, x: torch.Tensor, scan: str, lowp: bool):
    H, P, N = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    G, K = cfg["mamba_n_groups"], cfg["mamba_d_conv"]
    di = H * P
    b, T, _ = x.shape
    zxbcdt = _mm(x, p["in_proj"], lowp)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], -1)
    w = _w(p["conv_w"], lowp)[:, None, :]                             # (Cv, 1, K)
    conv = F.conv1d(xbc.transpose(1, 2), w, p["conv_b"].float(), padding=K - 1,
                    groups=w.shape[0])[..., :T]
    xbc = F.silu(conv.transpose(1, 2))
    xs, B, C = torch.split(xbc, [di, G * N, G * N], -1)
    xs = xs.reshape(b, T, H, P)
    B, C = B.reshape(b, T, G, N), C.reshape(b, T, G, N)
    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    if scan == "sequential":
        y, h = scan_sequential(xs, dt, A, B, C, lowp)
    else:
        y, h = scan_chunked(xs, dt, A, B, C, cfg["mamba_chunk_size"], lowp)
    y = y + p["D"].float()[:, None] * xs
    y = rms_norm(y.reshape(b, T, di) * F.silu(z), p["norm"], cfg["rms_norm_eps"])
    return _mm(y, p["out_proj"], lowp), h


def _attention(cfg: Dict, p: Dict, x: torch.Tensor, lowp: bool, q_block: int):
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    b, T, d = x.shape
    dh = d // hq
    q = _mm(x, p["q"], lowp).reshape(b, T, hq, dh).transpose(1, 2)
    k = _mm(x, p["k"], lowp).reshape(b, T, hkv, dh).transpose(1, 2).repeat_interleave(hq // hkv, 1)
    v = _mm(x, p["v"], lowp).reshape(b, T, hkv, dh).transpose(1, 2).repeat_interleave(hq // hkv, 1)
    outs = []
    for q0 in range(0, T, q_block):
        q1 = min(q0 + q_block, T)
        s = (q[:, :, q0:q1] @ k[:, :, :q1].transpose(-1, -2)) * cfg["attention_multiplier"]
        mask = torch.arange(q1, device=x.device)[None, :] <= torch.arange(q0, q1, device=x.device)[:, None]
        s = s.masked_fill(~mask, -torch.inf)
        outs.append(torch.softmax(s, -1) @ v[:, :, :q1])
    o = torch.cat(outs, 2).transpose(1, 2).reshape(b, T, hq * dh)
    return _mm(o, p["o"], lowp)


def forward(cfg: Dict, weights: Dict, tokens: torch.Tensor, *, scan: str = "chunked",
            lowp: bool = False, all_positions: bool = False,
            q_block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, T) -> (logits, Mamba-2 states).  logits (b, V) of the last
    position, or (b, T, V) with ``all_positions``; states (Mamba layers, b,
    H, P, N) after the last token, float32.

    ``weights``: ``embed`` (V, d), ``final_norm`` (d,), ``layers`` a list
    of per-layer dicts with ``input_layernorm``, ``post_attention_layernorm``
    (d,), ``mlp`` {``gate``, ``up`` (d, ff), ``down`` (ff, d)} and either
    ``mamba`` {``in_proj`` (d, 2Di + 2GN + H), ``conv_w`` (Di + 2GN, K),
    ``conv_b``, ``dt_bias``, ``A_log``, ``D``, ``norm`` (Di,), ``out_proj``
    (Di, d)} or ``attn`` {``q``, ``k``, ``v`` (d, heads x dh), ``o``}.
    """
    no_tf32()
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    embed = _w(weights["embed"], lowp)
    x = embed[tokens.long()] * cfg["embedding_multiplier"]
    states: List[torch.Tensor] = []
    for kind, lp in zip(cfg["layer_types"], weights["layers"]):
        h = rms_norm(x, lp["input_layernorm"], eps)
        if kind == "mamba":
            h, state = _mamba(cfg, lp["mamba"], h, scan, lowp)
            states.append(state)
        else:
            h = _attention(cfg, lp["attn"], h, lowp, q_block)
        x = x + rm * h
        h = rms_norm(x, lp["post_attention_layernorm"], eps)
        m = lp["mlp"]
        h = _mm(F.silu(_mm(h, m["gate"], lowp)) * _mm(h, m["up"], lowp), m["down"], lowp)
        x = x + rm * h
    x = rms_norm(x if all_positions else x[:, -1], weights["final_norm"], eps)
    logits = _mm(x, embed.t(), lowp) / cfg["logits_scaling"]
    return logits, torch.stack(states)


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = got.double().to(want.device), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))
