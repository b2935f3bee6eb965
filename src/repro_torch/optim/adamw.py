# Port of repro/optim/adamw.py.  What differs:
# * Parameter, gradient and moment trees are nested dicts of torch tensors;
#   the update runs under torch.no_grad() and returns new tensors (the
#   inputs are left as they were).  ``count`` is a 0-d int32 tensor on the
#   parameters' device, and ``lr`` may be a 0-d device tensor: nothing is
#   read back to the host.
# * The per-leaf math is JAX's, op for op in its order: float32 moments and
#   update, moments stored in ``moment_dtype``, new parameters cast back to
#   the parameter dtype.  XLA's CPU backend contracts none of these sums
#   into a fused multiply-add, so on the CPU each op rounds as JAX's does.
#   On the CPU the float32 square root goes through float64 (torch's CPU
#   float32 sqrt is not correctly rounded; XLA's and CUDA's are).
# * opt_state_specs (sharding) is not ported yet (ROADMAP, module item 10).
"""AdamW built from scratch, over dict trees of tensors.

The moment dtype is a per-config knob (the 340B cell needs bf16 moments).
Global-norm clipping is fused into the update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure (the first's)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def adamw_init(params: Params, moment_dtype: str = "float32") -> Dict:
    dt = _dtype(moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return _sqrt(torch.sum(torch.stack(leaves)))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float() if x.device.type == "cpu" else torch.sqrt(x)


@torch.no_grad()
def adamw_update(
    params: Params,
    grads: Params,
    state: Dict,
    lr,
    cfg: AdamWConfig = AdamWConfig(),
) -> Tuple[Params, Dict, Dict[str, torch.Tensor]]:
    count = state["count"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c = count.float()
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu32 = mu.float() * cfg.b1 + g * (1 - cfg.b1)
        nu32 = nu.float() * cfg.b2 + torch.square(g) * (1 - cfg.b2)
        mu_hat = mu32 / bc1
        nu_hat = nu32 / bc2
        step = mu_hat / (_sqrt(nu_hat) + cfg.eps) + cfg.weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda t: t[i], out) if isinstance(out, dict) else out[i]
    return (
        pick(0),
        {"mu": pick(1), "nu": pick(2), "count": count},
        {"grad_norm": gnorm},
    )
