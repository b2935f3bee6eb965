# Port of repro/models/moe.py.  What differs:
# * moe_params draws from a torch.Generator (other numbers than JAX's keys;
#   tests convert JAX's weights with convert.params_from_jax); the tree,
#   shapes and dtypes are JAX's.
# * The sort route's G dispatch groups run as one batch with the group as
#   the leading dim of every index tensor and of the capacity buffer
#   (G, E * cap + 1, d), where JAX vmaps the group's dispatch and combine;
#   so the groups split over "batch" with no exchange between them.  For
#   the expert products the buffer is laid out (E, G * cap, d): one product
#   batched over E on the stacked weights (JAX's "gecd,edf->gecf"), with no
#   copy of the weights.
# * The combine is a gather: each token takes its k slots back in the
#   order of the stable sort (ascending expert) and sums them one by one,
#   rounding to the model's dtype after each add, as XLA's scatter-add
#   into a zero buffer does.  No atomics, so two runs give the same bits.
# * The dense route's combine weights are scattered into a fresh buffer
#   (out-of-place scatter), as JAX's .at[].add into zeros.
# * The dense route (the oracle, and every decode step) runs its expert
#   products batched over E the same way, torch.matmul(x2d[None], w) ->
#   (E, T, f), where torch.einsum("td,edf->tef") may copy every expert's
#   weights into a fresh layout.
# * act(g) * u goes op by op (layers.activation_fn), as in mlp_apply.
# * with_logical returns a plain tensor as it is; it constrains only a
#   DTensor (the dry-run's meshes), at JAX's sites: the token groups on
#   "batch", the capacity buffer on ("batch", "experts") (on "experts"
#   without groups), the expert hidden state on ("experts", "batch",
#   "expert_ff") in the port's (E, G * cap, f) layout, and the output.
#   The router's scatter_reduce runs under the rule of
#   distributed/sharding.py (split along any dim but the scattered one).
"""Mixture-of-Experts FFN: top-k router + capacity-buffered sort dispatch.

Two implementations sharing the router:

* ``sort`` (production): sort the tokens' slots by expert, place them in
  per-expert capacity buffers, one product batched over the stacked expert
  weights, then gather back with gate weighting.  Over-capacity slots are
  dropped (standard Switch/GShard semantics; capacity_factor controls
  slack).  With ``dispatch_groups`` G > 1 each of G token groups dispatches
  on its own.
* ``dense`` (oracle): every expert processes every token, combined by gate
  weight.  O(E/k) more FLOPs; the correctness reference for the dispatch
  path, and the decode step's route.

Shared experts (Qwen-MoE, Llama-4) are a plain gated MLP added to the routed
output.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..distributed.sharding import with_logical
from ..kernels import is_dtensor
from .config import ModelConfig
from .layers import (
    activation_fn,
    dtype_of,
    einsum,
    matmul,
    mlp_apply,
    mlp_params,
    mlp_specs,
    normal_init,
)


def moe_params(cfg: ModelConfig, gen: torch.Generator, n: int) -> Dict:
    assert cfg.moe is not None
    m = cfg.moe
    d = cfg.d_model
    dt = dtype_of(cfg)
    s_in = d ** -0.5
    s_out = m.d_ff_expert ** -0.5
    p = {
        "router": normal_init(gen, (n, d, m.num_experts), s_in, torch.float32),
        "w_gate": normal_init(gen, (n, m.num_experts, d, m.d_ff_expert), s_in, dt),
        "w_up": normal_init(gen, (n, m.num_experts, d, m.d_ff_expert), s_in, dt),
        "w_down": normal_init(gen, (n, m.num_experts, m.d_ff_expert, d), s_out, dt),
    }
    if m.d_ff_shared:
        p["shared"] = mlp_params(cfg, gen, n, d_ff=m.d_ff_shared)
    return p


def moe_specs(cfg: ModelConfig) -> Dict:
    m = cfg.moe
    ep = m.expert_parallel
    e_ax = "experts" if ep else None
    f_ax = None if ep else "expert_ff"
    p = {
        "router": (None, "fsdp", None),
        "w_gate": (None, e_ax, "fsdp", f_ax),
        "w_up": (None, e_ax, "fsdp", f_ax),
        "w_down": (None, e_ax, f_ax, "fsdp"),
    }
    if m.d_ff_shared:
        p["shared"] = mlp_specs()
    return p


def _route(x2d: torch.Tensor, router: torch.Tensor, m
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (gates (T, k) f32, experts (T, k) int64, aux loss)."""
    logits = torch.matmul(x2d.float(), router)
    gates_all = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(gates_all, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance + router-z auxiliary losses (GShard / ST-MoE)
    density = torch.nn.functional.one_hot(experts[:, 0], m.num_experts).float().mean(0)
    density_prob = gates_all.mean(0)
    lb_loss = m.num_experts * torch.sum(density * density_prob)
    z_loss = m.router_z_loss * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, experts, lb_loss + z_loss


def _expert_mlp(w_gate, w_up, w_down, h: torch.Tensor, act, hidden=None) -> torch.Tensor:
    """h: (E, C, d) -> (E, C, d) through each expert's gated MLP, one product
    batched over E per projection; ``hidden`` the logical axes of the
    hidden state (E, C, f), if it is constrained."""
    g = matmul(h, w_gate)
    u = matmul(h, w_up)
    hh = act(g) * u
    if hidden:
        hh = with_logical(hh, *hidden)
    return matmul(hh, w_down)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[g, i]`` of group g of x (G, R, d): (G, n, d).  A DTensor
    gathers along its rows, each group on its own devices; a plain tensor
    indexes rows of the flattened groups (a row-copy kernel, where an
    elementwise gather costs the card about half as much again)."""
    if is_dtensor(x):
        return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))
    G, R, d = x.shape
    flat = idx + torch.arange(G, device=idx.device)[:, None] * R
    return x.reshape(G * R, d)[flat.reshape(-1)].reshape(G, -1, d)


def _put_rows(buf: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """buf (G, R, d) with row idx[g, i] of group g set to src[g, i] (the
    spare row, the only one named twice, takes any of its rows); split as
    ``src`` is."""
    if is_dtensor(src):
        return buf.scatter(1, idx[..., None].expand(*idx.shape, buf.shape[-1]), src)
    G, R, d = buf.shape
    flat = idx + torch.arange(G, device=idx.device)[:, None] * R
    buf.reshape(G * R, d)[flat.reshape(-1)] = src.reshape(-1, d)
    return buf


def _dispatch(x2d: torch.Tensor, experts: torch.Tensor, m, G: int, cap: int):
    """The tokens of G groups into capacity buffers, laid out (E, G * cap, d)
    for the expert products.

    Per group, the slots (token, rank) are sorted stably by expert; a slot's
    position within its expert's run is its index less the run's start, and
    a slot at or past ``cap`` goes to the group's spare row E * cap
    (dropped).  Returns the buffer, and per slot in (token, rank) order its
    row in its group's buffer (G, tg, k) and whether it was kept."""
    T, d = x2d.shape
    E, k = m.num_experts, m.top_k
    tg, n = T // G, (T // G) * k
    dev = x2d.device
    batch = "batch" if G > 1 else None
    se, order = torch.sort(experts.reshape(G, n), dim=-1, stable=True)
    pos = torch.arange(n, device=dev).expand(G, n)
    run_start = torch.full((G, E), n, dtype=torch.int64, device=dev).scatter_reduce(
        1, se, pos, "amin")
    pos_in_e = pos - run_start.gather(1, se)
    keep = pos_in_e < cap
    row = torch.where(keep, se * cap + pos_in_e, E * cap)
    # the tokens split on "batch" before the split into groups, so each
    # group lies whole on its devices (and the gradient's view back holds)
    xg = with_logical(x2d, batch, None).reshape(G, tg, d)
    buf = _put_rows(torch.zeros((G, E * cap + 1, d), dtype=x2d.dtype, device=dev), row,
                    _rows(xg, order // k))                  # each sorted slot's token
    h = with_logical(buf[:, :E * cap].reshape(G, E, cap, d), batch, "experts", None, None)
    # back to (token, rank) order: the inverse of each group's sort
    inv = torch.argsort(order, dim=-1)
    row = row.gather(1, inv).reshape(G, tg, k)
    keep = keep.gather(1, inv).reshape(G, tg, k)
    return h.transpose(0, 1).reshape(E, G * cap, d), row, keep


def _combine(yb: torch.Tensor, row: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """Each token's kept slots times their gates, summed in the order of the
    stable sort (ascending expert) from a zero row, one rounding per add.
    yb: (E, G * cap, d); row, keep: (G, tg, k); gates, experts: (T, k)."""
    E, _, d = yb.shape
    G, tg, k = row.shape
    batch = "batch" if G > 1 else None
    # the experts' outputs split as their inputs were, so the view back to
    # groups keeps whole experts per shard
    yb = with_logical(yb, "experts", batch, None)
    yg = yb.reshape(E, G, -1, d).transpose(0, 1).reshape(G, -1, d)
    yg = torch.cat([yg, yg.new_zeros((G, 1, d))], dim=1)     # the spare row
    by_expert = torch.argsort(experts, dim=-1)
    row = row.reshape(G * tg, k).gather(1, by_expert).reshape(G, tg, k)
    keep = keep.reshape(G * tg, k).gather(1, by_expert).reshape(G, tg, k)
    gates = with_logical(gates, batch, None)
    g = gates.gather(1, by_expert).to(yb.dtype).reshape(G, tg, k)
    y = torch.zeros((G, tg, d), dtype=yb.dtype, device=yb.device)
    for j in range(k):
        contrib = _rows(yg, row[:, :, j]) * g[:, :, j, None]
        y = y + torch.where(keep[:, :, j, None], contrib, 0.0)
    return y.reshape(G * tg, d)


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, decode: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss); p holds one layer's weights.

    ``decode=True`` forces the dense path: a decode step is weight-bandwidth
    bound (every expert's weights stream from memory regardless of routing),
    so capacity buffers would only add dropping artefacts for zero savings.
    """
    m = cfg.moe
    act = activation_fn(cfg.activation)
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, experts, aux = _route(x2d, p["router"], m)
    T = b * s

    if m.impl == "dense" or decode:
        # oracle: all experts on all tokens, (E, T, f) without copying weights
        y_all = _expert_mlp(p["w_gate"], p["w_up"], p["w_down"], x2d[None], act)
        combine = torch.zeros((T, m.num_experts), dtype=x.dtype, device=x.device).scatter(
            1, experts, gates.to(x.dtype))
        y = einsum("etd,te->td", y_all, combine)
    else:
        # sort-based capacity dispatch in G token groups
        G = max(1, m.dispatch_groups)
        assert T % G == 0, (T, G)
        tg = T // G
        cap = int(max(1, round(tg * m.top_k / m.num_experts * m.capacity_factor)))
        h, row, keep = _dispatch(x2d, experts, m, G, cap)
        yb = _expert_mlp(p["w_gate"], p["w_up"], p["w_down"], h, act,
                         hidden=("experts", "batch" if G > 1 else None, "expert_ff"))
        y = _combine(yb, row, keep, gates, experts)

    if m.d_ff_shared:
        y = y + mlp_apply(p["shared"], x, cfg).reshape(T, d)
    return with_logical(y.reshape(b, s, d), "batch", "seq", None), aux
