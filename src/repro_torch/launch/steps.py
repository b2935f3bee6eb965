# Port of repro/launch/steps.py: the training step (init_train_state,
# make_train_step) and the serving steps (make_prefill_step,
# make_decode_fn).  What differs:
# * There is no jit: the steps run eagerly, and the gradient is
#   torch.autograd through loss_and_aux (impl="reference" by default, as
#   JAX's value_and_grad differentiates; neither package has a backward
#   kernel).  A bfloat16 parameter's gradient is bfloat16, as JAX's is.
# * The train step returns a new state (new tensors; the old state is left
#   as it was) and its metrics as 0-d device tensors: nothing is read back
#   to the host.  Gradient accumulation is a Python loop over the
#   microbatches in lax.scan's order, summing in float32 (bfloat16 when the
#   moments are bfloat16) exactly where JAX casts.
# * init_train_state takes a torch.Generator (the params land on its
#   device).
# * The abstract shapes (abstract_*), train_state_specs, input_specs and
#   input_spec_names (sharding and dry runs) are not ported yet (ROADMAP,
#   module item 10), nor abstract_cache.
"""Step builders: the train step, prefill and greedy decode."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_params, loss_and_aux, prefill
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_map
from ..optim.schedule import cosine_schedule

Tree = Any


def init_train_state(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    params = init_params(cfg, gen)
    return {
        "params": params,
        "opt": adamw_init(params, cfg.moment_dtype),
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }


# ------------------------------------------------------------------- train
def make_train_step(
    cfg: ModelConfig,
    adamw: AdamWConfig = AdamWConfig(),
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    impl: str = "reference",
    grad_compression: Optional[str] = None,
) -> Callable[[Tree, Dict[str, torch.Tensor]], Tuple[Tree, Dict[str, torch.Tensor]]]:
    """``grad_compression``: None | "int8" | "topk:<frac>" — compresses the
    gradient before the DP all-reduce (bandwidth trick; int8 is unbiased-ish
    per-tensor symmetric quantization, top-k keeps an error-feedback residual
    in the optimizer state is future work — here the residual folds into the
    same step, making it a one-step-delayed correction)."""
    accum = max(1, cfg.grad_accum)
    grad_dt = torch.float32 if cfg.moment_dtype == "float32" else torch.bfloat16

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        loss, _ = loss_and_aux(cfg, tree_map(lambda _: next(it), params), batch, impl=impl)
        grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(state, batch):
        params = state["params"]
        if accum > 1:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=grad_dt, device=p.device),
                             params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(accum):
                loss, g = value_and_grad(params, {k: v[i] for k, v in micro.items()})
                with torch.no_grad():
                    tree_map(lambda a, b: a.add_(b.to(grad_dt)), grads, g)
                    loss_sum = loss_sum + loss
                del g
            with torch.no_grad():
                tree_map(lambda g: g.div_(accum), grads)
            loss = loss_sum / accum
        else:
            loss, grads = value_and_grad(params, batch)

        with torch.no_grad():
            if grad_compression == "int8":
                from ..optim.compression import dequantize_int8, quantize_int8

                def qdq(g):
                    q, s = quantize_int8(g)
                    return dequantize_int8(q, s, g.dtype)

                grads = tree_map(qdq, grads)
            elif grad_compression and grad_compression.startswith("topk:"):
                frac = float(grad_compression.split(":", 1)[1])
                from ..optim.compression import compress_topk, decompress_topk

                def topk(g):
                    vals, idx, _ = compress_topk(g, frac)
                    return decompress_topk(vals, idx, g.shape, g.dtype)

                grads = tree_map(topk, grads)

            lr = cosine_schedule(state["step"], warmup, total_steps, peak_lr)
            new_params, new_opt, stats = adamw_update(params, grads, state["opt"], lr, adamw)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        metrics = {"loss": loss, "lr": lr, **stats}
        return new_state, metrics

    return train_step


# ------------------------------------------------------------------- serve
def make_prefill_step(cfg: ModelConfig, impl: str = "reference"):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch["tokens"], batch.get("patches"), impl=impl)

    return prefill_step


def make_decode_fn(cfg: ModelConfig):
    def serve_step(params, cache, token):
        logits, new_cache = decode_step(cfg, params, token, cache)
        next_token = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
        return next_token, new_cache

    return serve_step
