"""Plain PyTorch version of the RWKV-6 scan (the kernel's oracle): the
step-by-step transcription of ``repro/kernels/rwkv6_scan/ref.py``, with
``lax.scan`` written as a loop over the tokens.  With ``return_state`` it
also returns the loop's final state, as the CUDA kernel does."""
from __future__ import annotations

import torch


def rwkv6_reference(r, k, v, w, u, return_state: bool = False):
    """r, k, v, w: (B, H, T, D); u: (H, D) -> (B, H, T, D) f32, or with
    ``return_state`` (that, the final state S (B, H, D, D) f32)."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    b, h, t, d = r.shape
    S = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    ys = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    for i in range(t):
        rt, kt, vt, wt = r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i]  # (B, H, D)
        kv = kt[..., :, None] * vt[..., None, :]                          # (B, H, D, D)
        att = S + u[None, :, :, None] * kv
        ys[:, :, i] = torch.einsum("bhk,bhkv->bhv", rt, att)
        S = wt[..., :, None] * S + kv
    return (ys, S) if return_state else ys


def rwkv6_reference_backward(r, k, v, w, u, dy, dS=None):
    """The gradient of :func:`rwkv6_reference`: r, k, v, w, dy (B, H, T, D),
    u (H, D), dS the final state's gradient (B, H, D, D) or None ->
    (dr, dk, dv, dw) (B, H, T, D) f32 and du per sequence (B, H, D) f32.

    The loop runs forward once to keep each step's incoming state, then
    backward with the state's gradient G carried:
    dr_t = att_t dy_t, dkv = u∘(r_t ⊗ dy_t) + G, dk_t = dkv v_t,
    dv_t = dkv^T k_t, dw_t = rowsum(G∘S_{t-1}), G <- r_t ⊗ dy_t + w_t∘G."""
    r, k, v, w, dy = (x.float() for x in (r, k, v, w, dy))
    u = u.float()
    b, h, t, d = r.shape
    states = torch.empty((t, b, h, d, d), dtype=torch.float32, device=r.device)
    S = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    for i in range(t):
        states[i] = S
        S = w[:, :, i, :, None] * S + k[:, :, i, :, None] * v[:, :, i, None, :]
    G = torch.zeros_like(S) if dS is None else dS.float().clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((b, h, d), dtype=torch.float32, device=r.device)
    for i in reversed(range(t)):
        rt, kt, vt, wt, dyt = r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i], dy[:, :, i]
        kv = kt[..., :, None] * vt[..., None, :]
        att = states[i] + u[None, :, :, None] * kv
        dr[:, :, i] = torch.einsum("bhkv,bhv->bhk", att, dyt)
        d_att = rt[..., :, None] * dyt[..., None, :]
        du += (d_att * kv).sum(-1)
        dkv = u[None, :, :, None] * d_att + G
        dk[:, :, i] = torch.einsum("bhkv,bhv->bhk", dkv, vt)
        dv[:, :, i] = torch.einsum("bhkv,bhk->bhv", dkv, kt)
        dw[:, :, i] = (G * states[i]).sum(-1)
        G = d_att + wt[..., :, None] * G
    return dr, dk, dv, dw, du
