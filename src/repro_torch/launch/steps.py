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
#   moments are bfloat16) exactly where JAX casts.  Microbatch i is rows
#   [i * mb, (i + 1) * mb) of the batch, as JAX's reshape to (accum, mb)
#   gives it, taken as a slice: DTensor cannot split a dim sharded over two
#   mesh axes by a reshape.  On a DTensor the slice is sharded again over
#   the batch axes (with_logical).
# * init_train_state takes a torch.Generator (the params land on its
#   device).
# * Where JAX gives ShapeDtypeStructs (abstract_*, input_specs), the port
#   gives tensors on torch's "meta" device: init_params and init_cache run
#   under a FakeTensorMode (jax.eval_shape's counterpart) and each leaf
#   becomes an empty meta tensor of its shape and dtype.  abstract_params,
#   abstract_train_state and abstract_cache take the "model" axis's size
#   and pad the heads to it (models/padding.py), where XLA pads them in
#   the compiled step.
# * make_decode_fn's step also returns the step's logits (B, V), after the
#   next token and the cache.
"""Step functions shared by the trainer, server, and dry-run.

They are mesh-agnostic; spec trees hold *logical* axis-name tuples
that the caller resolves against a concrete mesh
(``repro_torch.distributed.sharding``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..distributed.sharding import gathered, with_logical
from ..models.config import ModelConfig, ShapeConfig
from ..models.padding import pad_cache, pad_params
from ..models.transformer import (
    decode_step,
    init_cache,
    init_params,
    loss_and_aux,
    param_specs,
    prefill,
)
from ..optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    opt_state_specs,
    tree_leaves,
    tree_map,
)
from ..optim.schedule import cosine_schedule

Tree = Any


# ----------------------------------------------------------------- abstract
def _abstract(build) -> Tree:
    """``build()``'s tree with every leaf an empty meta tensor of its shape
    and dtype; nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = build()
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def abstract_params(cfg: ModelConfig, split: int = 1) -> Tree:
    """The parameters' abstract tree, the heads padded to ``split`` (the
    "model" axis they are placed on; models/padding.py)."""
    return _abstract(lambda: pad_params(cfg, init_params(cfg, torch.Generator()), split))


def abstract_train_state(cfg: ModelConfig, split: int = 1) -> Tree:
    params = abstract_params(cfg, split)
    opt = _abstract(lambda: adamw_init(params, cfg.moment_dtype))
    return {"params": params, "opt": opt,
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def train_state_specs(cfg: ModelConfig, tp: int = 16) -> Tree:
    pspecs = param_specs(cfg, tp)
    return {"params": pspecs, "opt": opt_state_specs(pspecs), "step": ()}


def init_train_state(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    params = init_params(cfg, gen)
    return {
        "params": params,
        "opt": adamw_init(params, cfg.moment_dtype),
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }


# -------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell.

    Modality frontends are stubs: the audio arch takes EnCodec code ids
    (ordinary tokens), the VLM takes pre-projected patch embeddings.
    """
    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.mode in ("train", "prefill"):
        s_text = shape.seq_len - cfg.frontend_tokens
        extra = 1 if shape.mode == "train" else 0
        out = {"tokens": meta((shape.global_batch, s_text + extra), torch.int32)}
        if cfg.frontend_tokens:
            out["patches"] = meta((shape.global_batch, cfg.frontend_tokens, cfg.d_model),
                                  torch.float32)
        return out
    # decode: one new token + the KV/recurrent cache at seq_len
    return {"token": meta((shape.global_batch, 1), torch.int32)}


def input_spec_names(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    if shape.mode in ("train", "prefill"):
        out = {"tokens": ("batch", None)}
        if cfg.frontend_tokens:
            out["patches"] = ("batch", None, None)
        return out
    return {"token": ("batch", None)}


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
            mb = next(iter(batch.values())).shape[0] // accum
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=grad_dt), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(accum):
                loss, g = value_and_grad(params, {k: with_logical(v[i * mb:(i + 1) * mb], "batch")
                                                  for k, v in batch.items()})
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
    """Greedy decode step: (params, cache, token) -> (next token, cache,
    the step's logits (B, V))."""
    def serve_step(params, cache, token):
        logits, new_cache = decode_step(cfg, params, token, cache)
        # the vocab gathered first: DTensor's argmax over a sharded dim fails at batch 1
        last = gathered(logits[:, -1, :], -1)
        next_token = last.argmax(dim=-1).to(torch.int32)[:, None]
        return next_token, new_cache, last

    return serve_step


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig, split: int = 1) -> Tree:
    return _abstract(lambda: pad_cache(cfg, init_cache(cfg, shape.global_batch,
                                                       max_len=shape.seq_len, device="cpu"),
                                       split))
