"""IBM Granite-4.0-H-Micro, 3.2B parameters
[https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json;
HF model_type ``granitemoehybrid``]: 40 layers, 36 Mamba-2 and 4 GQA
attention layers (at 5, 15, 25 and 35) with no position embedding, a
SwiGLU MLP of width 8192 after every mixer, no experts, tied embeddings.

Layer groups (``groups_from_layer_types``): (m x 5, attn) x 1,
(m x 9, attn) x 3, (m x 4) x 1.  The JAX package has no such arch: it is
registered in ``PORT_ARCHS``.
"""
from typing import Dict

from ..models.config import HybridConfig, MambaConfig, groups_from_layer_types

#: the published config.json's keys that shape the model
HF_CONFIG: Dict = {
    "attention_multiplier": 0.015625,
    "embedding_multiplier": 12,
    "hidden_size": 2048,
    "intermediate_size": 8192,
    "shared_intermediate_size": 8192,
    "layer_types": ["mamba"] * 5 + ["attention"] + (["mamba"] * 9 + ["attention"]) * 3
                   + ["mamba"] * 4,
    "logits_scaling": 8,
    "mamba_chunk_size": 256,
    "mamba_conv_bias": True,
    "mamba_d_conv": 4,
    "mamba_d_head": 64,
    "mamba_d_state": 128,
    "mamba_expand": 2,
    "mamba_n_groups": 1,
    "mamba_n_heads": 64,
    "mamba_proj_bias": False,
    "num_attention_heads": 32,
    "num_hidden_layers": 40,
    "num_key_value_heads": 8,
    "position_embedding_type": "nope",
    "residual_multiplier": 0.22,
    "rms_norm_eps": 1e-05,
    "rope_theta": 10000,
    "tie_word_embeddings": True,
    "vocab_size": 100352,
}


def from_hf(hf: Dict, name: str, dtype: str = "bfloat16") -> HybridConfig:
    """A HF ``granitemoehybrid`` config with no experts as a HybridConfig.
    Refuses what the port does not compute: experts, projection biases, a
    Mamba width other than ``mamba_expand * hidden_size``."""
    if hf.get("num_local_experts", 0) or hf.get("mamba_proj_bias", False) \
            or hf.get("attention_bias", False):
        raise ValueError(f"{name}: experts and projection biases are not supported")
    d = int(hf["hidden_size"])
    mamba = MambaConfig(n_heads=int(hf["mamba_n_heads"]), head_dim=int(hf["mamba_d_head"]),
                        d_state=int(hf["mamba_d_state"]), n_groups=int(hf["mamba_n_groups"]),
                        d_conv=int(hf["mamba_d_conv"]), chunk=int(hf["mamba_chunk_size"]),
                        conv_bias=bool(hf["mamba_conv_bias"]))
    if mamba.d_inner != int(hf["mamba_expand"]) * d:
        raise ValueError(f"{name}: mamba heads x head dim != expand x hidden size")
    heads = int(hf["num_attention_heads"])
    return HybridConfig(
        name=name,
        family="hybrid",
        n_layers=int(hf["num_hidden_layers"]),
        d_model=d,
        n_heads=heads,
        n_kv_heads=int(hf["num_key_value_heads"]),
        d_head=int(hf.get("head_dim") or d // heads),
        d_ff=int(hf["shared_intermediate_size"]),
        vocab=int(hf["vocab_size"]),
        activation="silu",
        rope_theta=float(hf["rope_theta"]),
        norm_eps=float(hf["rms_norm_eps"]),
        tie_embeddings=bool(hf["tie_word_embeddings"]),
        layer_groups=groups_from_layer_types(hf["layer_types"]),
        dtype=dtype,
        mamba=mamba,
        embedding_multiplier=float(hf["embedding_multiplier"]),
        residual_multiplier=float(hf["residual_multiplier"]),
        logits_scaling=float(hf["logits_scaling"]),
        attn_scale=float(hf["attention_multiplier"]),
        rope=hf["position_embedding_type"] != "nope",
    ).validate()


CONFIG = from_hf(HF_CONFIG, "granite-4.0-h-micro")
