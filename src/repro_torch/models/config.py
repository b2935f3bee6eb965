# Copy of repro/models/config.py; unchanged.
"""Model / shape configuration for the architecture zoo.

One :class:`ModelConfig` describes any of the ten assigned architectures
(dense GQA, MoE, SSM/RWKV-6, RG-LRU hybrid, audio/VLM backbones).  Layer
stacks are described as *groups* — ``(pattern, repeat)`` pairs — so hybrids
like RecurrentGemma's (rec, rec, attn) x 12 + (rec, rec) compile as one
``lax.scan`` per group.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence, Tuple

LayerKind = Literal["attn", "rec", "rwkv"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0          # shared-expert MLP width (0 = none)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    impl: Literal["sort", "dense"] = "sort"
    #: shard experts over "model" (EP) when num_experts divides the axis,
    #: else shard the expert FF dim (TP)
    expert_parallel: bool = True
    #: dispatch in G token groups (group dim sharded with the batch) so the
    #: sort/scatter stays shard-local; 1 = one global dispatch (baseline)
    dispatch_groups: int = 1


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (RecurrentGemma) block parameters."""

    d_rnn: int = 0                # recurrence width (lru_width)
    conv_width: int = 4
    window: int = 2048            # local-attention window of the hybrid


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    activation: Literal["silu", "gelu", "relu2"] = "silu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    rec: Optional[RecurrentConfig] = None
    rwkv: Optional[RWKVConfig] = None
    #: layer groups: ((kind, kind, ...), repeat); default = all-attn
    layer_groups: Optional[Tuple[Tuple[Tuple[str, ...], int], ...]] = None
    #: number of prepended frontend embeddings (VLM patches); 0 = none
    frontend_tokens: int = 0
    #: attention is quadratic unless a window bounds it
    attn_window: Optional[int] = None
    dtype: str = "bfloat16"
    #: Adam moment dtype — f32 default, bf16 for the very large archs
    moment_dtype: str = "float32"
    remat: bool = True
    #: microbatches for gradient accumulation (1 = none)
    grad_accum: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def groups(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        if self.layer_groups is not None:
            return self.layer_groups
        return ((("attn",), self.n_layers),)

    def total_layers(self) -> int:
        return sum(len(pat) * rep for pat, rep in self.groups)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token contexts?  SSM / windowed-attn only."""
        kinds = {k for pat, _ in self.groups for k in pat}
        if "attn" in kinds and self.attn_window is None:
            return False
        return True

    def validate(self) -> "ModelConfig":
        assert self.total_layers() == self.n_layers, (
            f"{self.name}: groups sum to {self.total_layers()} != {self.n_layers}"
        )
        if self.family == "moe":
            assert self.moe is not None
        kinds = {k for pat, _ in self.groups for k in pat}
        if "rec" in kinds:
            assert self.rec is not None and self.rec.d_rnn > 0
        if "rwkv" in kinds:
            assert self.rwkv is not None
        return self


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: sequence x batch x step kind."""

    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch, shape) a runnable cell?  Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k context needs sub-quadratic attention"
    return True, ""


def scaled_down(cfg: ModelConfig, layers: int = 2, width: int = 64) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    ratio = width / cfg.d_model
    d_head = max(16, int(cfg.head_dim * ratio) // 8 * 8) if cfg.d_head else None
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    groups: Optional[Tuple] = None
    if cfg.layer_groups is not None:
        # keep one group with the full pattern, repeated once
        pat = cfg.layer_groups[0][0]
        groups = ((pat, 1),)
        layers = len(pat)
    moe = None
    if cfg.moe:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=width * 2, d_ff_shared=(width * 2 if cfg.moe.d_ff_shared else 0),
        )
    rec = dataclasses.replace(cfg.rec, d_rnn=width, window=32) if cfg.rec else None
    rwkv = dataclasses.replace(cfg.rwkv, head_dim=16) if cfg.rwkv else None
    return dataclasses.replace(
        cfg,
        n_layers=layers,
        d_model=width,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=width // n_heads,
        d_ff=width * 3,
        vocab=256,
        moe=moe,
        rec=rec,
        rwkv=rwkv,
        layer_groups=groups,
        frontend_tokens=min(cfg.frontend_tokens, 4),
        attn_window=min(cfg.attn_window, 32) if cfg.attn_window else None,
        grad_accum=1,
    ).validate()
