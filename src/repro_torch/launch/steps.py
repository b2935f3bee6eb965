# Port of repro/launch/steps.py, the serving steps only (make_prefill_step,
# make_decode_fn).  There is no jit: the steps run eagerly.  The training
# step, its optimizer and the abstract shapes are not ported yet (ROADMAP,
# module item 8).
"""Step builders: prefill and greedy decode."""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import decode_step, prefill


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
