"""Operations and bytes of a Granite-4.0-H decode step
(``bench/configs/granite-4.0-h-micro.json``), and the bf16 peak.

One decode step of ``batch`` sessions, each attending ``length`` positions
(the position it writes included), counted from the configuration's
published keys.  Operations: each product's 2 * m * n * k, the attention's
two products over the attended positions, the state update's 5 per state
element (decay, outer product, sum; the output's multiply-add).  Bytes,
the least the step needs: every weight read once (bf16; A_log, dt_bias
and D float32; the tied embedding once, for the logits), the Mamba state
(float32) and conv state (bf16) read and written once, K and V read up to
``length`` and the new position's written, the logits written (bf16).
Activations between layers are left out: a fused step keeps them on chip.
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import HBM_BYTES_PER_S

#: NVIDIA H100 SXM data sheet, dense bf16 tensor-core rate, at the 700 W limit
BF16_FLOPS_PER_S = 989.4e12


def _shapes(c: Dict) -> Dict[str, int]:
    d, hq = int(c["hidden_size"]), int(c["num_attention_heads"])
    H, P = int(c["mamba_n_heads"]), int(c["mamba_d_head"])
    G, N, K = int(c["mamba_n_groups"]), int(c["mamba_d_state"]), int(c["mamba_d_conv"])
    kinds = list(c["layer_types"])
    return {"d": d, "dh": d // hq, "hq": hq, "hkv": int(c["num_key_value_heads"]),
            "ff": int(c["shared_intermediate_size"]), "V": int(c["vocab_size"]),
            "H": H, "P": P, "G": G, "N": N, "K": K, "Di": H * P, "Cv": H * P + 2 * G * N,
            "proj": 2 * H * P + 2 * G * N + H, "Lm": kinds.count("mamba"),
            "La": kinds.count("attention"), "L": len(kinds)}


def weight_bytes(c: Dict, itemsize: int = 2) -> int:
    """Bytes of every weight once: bf16 matrices, vectors and norms; the
    Mamba layers' A_log, dt_bias and D in float32."""
    s = _shapes(c)
    d = s["d"]
    mamba = (d * s["proj"] + s["Cv"] * s["K"] + s["Cv"] + s["Di"] + s["Di"] * d) * itemsize \
        + 3 * s["H"] * 4
    attn = (d * s["hq"] * s["dh"] * 2 + d * s["hkv"] * s["dh"] * 2) * itemsize
    per_layer = (2 * d + 3 * d * s["ff"]) * itemsize
    return (s["Lm"] * mamba + s["La"] * attn + s["L"] * per_layer
            + (s["V"] * d + d) * itemsize)


def decode_step_counts(c: Dict, batch: int, length: int) -> Tuple[float, int]:
    """(operations, bytes) of one decode step of ``batch`` sessions that
    attend ``length`` positions each."""
    s = _shapes(c)
    d, b = s["d"], batch
    mamba_ops = 2 * d * s["proj"] + 2 * s["Cv"] * s["K"] + 5 * s["H"] * s["P"] * s["N"] \
        + 2 * s["Di"] * d
    attn_ops = 2 * d * (s["hq"] + 2 * s["hkv"]) * s["dh"] + 2 * s["hq"] * s["dh"] * d \
        + 4 * s["hq"] * s["dh"] * length
    ops = b * (s["Lm"] * mamba_ops + s["La"] * attn_ops + s["L"] * 6 * d * s["ff"]
               + 2 * d * s["V"])
    state = s["Lm"] * b * (2 * s["H"] * s["P"] * s["N"] * 4 + 2 * s["Cv"] * (s["K"] - 1) * 2)
    kv = s["La"] * b * 2 * s["hkv"] * s["dh"] * 2 * (length + 1)
    logits = b * s["V"] * 2
    return float(ops), weight_bytes(c) + state + kv + logits


def decode_step_bound_s(c: Dict, batch: int, length: int) -> float:
    """Least time of the step: the larger of its operations at the bf16
    peak and its bytes at the HBM rate."""
    ops, nbytes = decode_step_counts(c, batch, length)
    return max(ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def ssm_update_bytes(batch: int, heads: int, head_dim: int, d_state: int,
                     groups: int = 1) -> int:
    """Bytes one ``ssm_update`` launch needs (float32): the state read once
    and written once, x read and y written, dt, A and D, B and C read once:
    ``4 * (2*Bt*H*P*N + 2*Bt*H*P + Bt*H + 2*H + 2*Bt*G*N)``."""
    b, h, p, n, g = batch, heads, head_dim, d_state, groups
    return 4 * (2 * b * h * p * n + 2 * b * h * p + b * h + 2 * h + 2 * b * g * n)


def ssm_update_bound_s(c: Dict, batch: int) -> float:
    """Least time of one ``ssm_update`` launch over ``batch`` sessions."""
    s = _shapes(c)
    return ssm_update_bytes(batch, s["H"], s["P"], s["N"], s["G"]) / HBM_BYTES_PER_S
