# Copy of repro/models/config.py.  What differs: the layer kind "mamba"
# (Mamba-2, arXiv:2405.21060) and HybridConfig, a ModelConfig with a
# MambaConfig and Granite-4.0-H's scalars, for the archs only the port runs
# (configs.PORT_ARCHS); ModelConfig's own fields are JAX's, so asdict of the
# ten shared archs stays equal.  groups_from_layer_types reads a published
# per-layer kind list into layer groups; scaled_down shrinks MambaConfig too.
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

LayerKind = Literal["attn", "rec", "rwkv", "mamba"]


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
class MambaConfig:
    """Mamba-2 mixer (state-space duality, arXiv:2405.21060): ``n_heads``
    heads of ``head_dim`` channels, each with a ``d_state``-wide state per
    channel; B and C shared by the heads of each of ``n_groups`` groups; a
    depthwise causal conv of ``d_conv`` taps over x, B and C; the prefill's
    chunked scan in chunks of ``chunk`` tokens."""

    n_heads: int
    head_dim: int
    d_state: int
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    conv_bias: bool = True

    @property
    def d_inner(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        """Channels of the conv: x, B and C."""
        return self.d_inner + 2 * self.n_groups * self.d_state


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
class HybridConfig(ModelConfig):
    """A ModelConfig with Mamba-2 layers (kind "mamba") and the scalars of
    IBM's Granite-4.0-H (HF ``granitemoehybrid``): the embedding times
    ``embedding_multiplier``, each sublayer's output times
    ``residual_multiplier`` before its residual add, the logits divided by
    ``logits_scaling``, attention scores times ``attn_scale`` (None: the
    head dim's inverse root) and no rotary embedding unless ``rope``."""

    mamba: Optional[MambaConfig] = None
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attn_scale: Optional[float] = None
    rope: bool = True

    def validate(self) -> "HybridConfig":
        super().validate()
        kinds = {k for pat, _ in self.groups for k in pat}
        if "mamba" in kinds:
            m = self.mamba
            assert m is not None and m.n_heads % m.n_groups == 0, self.name
        return self


def groups_from_layer_types(types: Sequence[str]) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
    """Layer groups from a per-layer kind list ("mamba" / "attention", as a
    HF ``layer_types`` gives it): the list cut after each attention layer,
    equal neighbouring pieces merged into one group with a repeat count."""
    kinds = ["attn" if t == "attention" else t for t in types]
    pieces, cur = [], []
    for k in kinds:
        cur.append(k)
        if k == "attn":
            pieces.append(tuple(cur))
            cur = []
    if cur:
        pieces.append(tuple(cur))
    groups: list = []
    for pat in pieces:
        if groups and groups[-1][0] == pat:
            groups[-1][1] += 1
        else:
            groups.append([pat, 1])
    return tuple((pat, rep) for pat, rep in groups)


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
    extra = {}
    if isinstance(cfg, HybridConfig) and cfg.mamba is not None:
        # heads of 16 channels; the inner width keeps its ratio to d_model
        extra["mamba"] = dataclasses.replace(
            cfg.mamba, n_heads=max(2, cfg.mamba.d_inner * width // cfg.d_model // 16),
            head_dim=16, d_state=16, chunk=8)
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
        **extra,
    ).validate()
