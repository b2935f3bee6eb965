"""Granite-4.0-H's weights, prompts and checked sessions from the seed.

The weights follow the published initialisation (HF's ``_init_weights``
and Mamba-2's): every projection and the (tied) embedding normal with std
``initializer_range``; the conv's weight and bias uniform on +-1/sqrt(taps)
(PyTorch's Conv1d default); A uniform on [1, 16] as ``A_log``; dt
log-uniform on [1e-3, 1e-1] stored as ``dt_bias`` through the inverse
softplus; D 1; every norm's weight 1.  They are drawn on the device in the
tree ``repro_torch.models.init_params`` gives (norm weights as ``gamma``,
applied as ``1 + gamma``); :func:`layer_views` hands the same tensors to
the plain reference in its own layout.  Prompts are token ids uniform over
the vocabulary.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..harness import subseed


def port_config(config: Dict):
    """The port's HybridConfig of a configuration file (its published keys)."""
    from repro_torch.configs.granite_4_0_h_micro import from_hf

    return from_hf(config, config["name"], dtype=config["dtype"])


def _generator(seed: int, purpose: str, device: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, purpose))


def make_weights(cfg, config: Dict, seed: int, device: str) -> Dict:
    """The port's parameter tree, drawn layer by layer on ``device``."""
    gen = _generator(seed, "granite4h-weights", device)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]
    std = float(config["initializer_range"])

    def normal(*shape):
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):  # one layer's f32 draw at a time
            out[i] = torch.randn(shape[1:], generator=gen, device=device).mul_(std)
        return out

    def uniform(lo, hi, *shape):
        return (torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    d, ff, m = cfg.d_model, cfg.d_ff, cfg.mamba
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params: Dict = {"embed": normal(cfg.vocab, d), "final_norm": zeros(d)}
    for gi, (pattern, n) in enumerate(cfg.groups):
        group = {}
        for pi, kind in enumerate(pattern):
            lp = {"norm1": zeros(n, d), "norm2": zeros(n, d)}
            if kind == "attn":
                lp["attn"] = {"wq": normal(n, d, hq * dh), "wk": normal(n, d, hkv * dh),
                              "wv": normal(n, d, hkv * dh), "wo": normal(n, hq * dh, d)}
            elif kind == "mamba":
                bound = m.d_conv ** -0.5
                step = torch.exp(torch.rand((n, m.n_heads), generator=gen, device=device)
                                 * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
                a = 1.0 + 15.0 * torch.rand((n, m.n_heads), generator=gen, device=device)
                proj = 2 * m.d_inner + 2 * m.n_groups * m.d_state + m.n_heads
                lp["mamba"] = {
                    "in_proj": normal(n, d, proj),
                    "conv_w": uniform(-bound, bound, n, m.conv_dim, m.d_conv),
                    "conv_b": uniform(-bound, bound, n, m.conv_dim),
                    "dt_bias": step + torch.log(-torch.expm1(-step)),
                    "A_log": torch.log(a),
                    "D": torch.ones((n, m.n_heads), dtype=torch.float32, device=device),
                    "norm": zeros(n, m.d_inner),
                    "out_proj": normal(n, m.d_inner, d),
                }
            else:
                raise ValueError(f"no weights for a layer of kind {kind!r}")
            lp["mlp"] = {"w_gate": normal(n, d, ff), "w_up": normal(n, d, ff),
                         "w_down": normal(n, ff, d)}
            group[f"pos{pi}"] = lp
        params[f"group{gi}"] = group
    return params


def layer_views(cfg, params: Dict) -> Dict:
    """The weights in the reference's layout (``reference.granite4h.forward``),
    in layer order: views of ``params``, and each norm's weight ``1 + gamma``."""
    def norm(g):
        return 1.0 + g.float()

    layers: List[Dict] = []
    for gi, (pattern, n) in enumerate(cfg.groups):
        for i in range(n):
            for pi, kind in enumerate(pattern):
                lp = params[f"group{gi}"][f"pos{pi}"]
                mlp = lp["mlp"]
                layer = {"input_layernorm": norm(lp["norm1"][i]),
                         "post_attention_layernorm": norm(lp["norm2"][i]),
                         "mlp": {"gate": mlp["w_gate"][i], "up": mlp["w_up"][i],
                                 "down": mlp["w_down"][i]}}
                if kind == "attn":
                    a = lp["attn"]
                    layer["attn"] = {"q": a["wq"][i], "k": a["wk"][i], "v": a["wv"][i],
                                     "o": a["wo"][i]}
                else:
                    mb = {k: v[i] for k, v in lp["mamba"].items()}
                    mb["norm"] = norm(mb["norm"])
                    layer["mamba"] = mb
                layers.append(layer)
    return {"embed": params["embed"], "final_norm": norm(params["final_norm"]),
            "layers": layers}


def make_prompts(config: Dict, traffic: Dict, seed: int, device: str) -> torch.Tensor:
    """(sessions, context) int32 token ids, uniform over the vocabulary."""
    gen = _generator(seed, "granite4h-prompts", device)
    return torch.randint(0, int(config["vocab_size"]),
                         (int(traffic["sessions"]), int(traffic["context"])), generator=gen,
                         device=device, dtype=torch.int32)


def check_sessions(traffic: Dict, seed: int) -> List[int]:
    """The sessions the output check compares, drawn from the seed."""
    rng = np.random.default_rng(subseed(seed, "granite4h-check"))
    pick = rng.choice(int(traffic["sessions"]), size=int(traffic["check_sessions"]),
                      replace=False)
    return sorted(int(i) for i in pick)
