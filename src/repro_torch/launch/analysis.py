# Port of repro/launch/analysis.py.  What differs:
# * The hardware is the NVIDIA H100 SXM, and the constants are its
#   DATA-SHEET values, not measurements: 989.4 TFLOP/s dense bf16, 3.35 TB/s
#   of HBM3; for collectives 450 GB/s per direction over NVLink 4 for a
#   group inside one 8-GPU node and 50 GB/s (400 Gb/s NDR per GPU) for a
#   group that spans nodes.  No TPU number stays here.
# * roofline_from_compiled becomes roofline_from_counts: there is no
#   compiled module, and the counts come from launch/op_cost.py (aten ops on
#   the local shards; its bytes are an upper bound, eager runs no fusion).
#   Each mesh dim's collective bytes are priced at the link its groups
#   cross.  There are no cost_analysis cross-checks (*_raw).
# * memory_stats["peak_hbm_bytes"] is whatever the caller measured and
#   passes in: the dry-run's MemTracker peak on a host mesh, the card's
#   max_memory_allocated on "h100".
# * param_counts and model_flops_for are copied unchanged.
"""Roofline terms of one step from its counted costs.

Hardware model (NVIDIA H100 SXM, data sheet):
    peak bf16 compute   989.4 TFLOP/s / GPU (dense)
    HBM bandwidth       3.35 TB/s     / GPU
    NVLink 4            450 GB/s      / GPU, per direction, inside a node
    network             50 GB/s       / GPU (400 Gb/s NDR) across nodes

Terms per (arch x shape x mesh) cell — all in seconds-per-step, per GPU:

    compute    = FLOPs / peak
    memory     = bytes / HBM_bw
    collective = sum over mesh dims of wire bytes / that dim's link
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NETWORK_BW = 50e9
#: GPUs per node: a group whose ranks share a node talks over NVLink
NODE_SIZE = 8


@dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    n_collectives: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    memory_stats: Dict[str, float] = field(default_factory=dict)
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    trip_counts: List[int] = field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective_bytes,
            "n_collectives": self.n_collectives,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "memory_stats": self.memory_stats,
            "collective_breakdown": self.collective_breakdown,
            "trip_counts": self.trip_counts,
        }


def link_bandwidth(mesh, dims: str) -> float:
    """The link a group over the "+"-joined mesh ``dims`` crosses: NVLink
    when this process's group sits in one node, the network otherwise."""
    names = mesh.mesh_dim_names
    span = dims.split("+")
    coord = mesh.get_coordinate()
    ranks = mesh.mesh[tuple(slice(None) if n in span else coord[i]
                            for i, n in enumerate(names))].flatten().tolist()
    return NVLINK_BW if len({r // NODE_SIZE for r in ranks}) <= 1 else NETWORK_BW


def roofline_from_counts(
    cost,
    n_devices: int,
    model_flops: float,
    mesh,
    memory_stats: Optional[Dict[str, float]] = None,
) -> RooflineTerms:
    """Roofline terms from an :class:`~repro_torch.launch.op_cost.OpCost`."""
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes_accessed / HBM_BW
    collective_s = sum(b / link_bandwidth(mesh, dim)
                       for dim, b in cost.collective_bytes_by_dim.items())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
    per_dev_model = model_flops / n_devices
    useful = per_dev_model / cost.flops if cost.flops else 0.0
    return RooflineTerms(
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes_accessed,
        collective_bytes=cost.collective_bytes,
        n_collectives=int(cost.n_collectives),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=useful,
        memory_stats=dict(memory_stats or {}),
        collective_breakdown=dict(cost.collective_breakdown),
        trip_counts=list(cost.trip_counts),
    )


# --------------------------------------------------------- model FLOP counts
def param_counts(cfg) -> Dict[str, float]:
    """Analytic parameter counts: total / active (MoE top-k) / embeddings."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = V * d * (1 if cfg.tie_embeddings else 2)
    total = 0.0
    active = 0.0
    for pattern, rep in cfg.groups:
        for kind in pattern:
            if kind == "attn":
                mix = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
            elif kind == "rec":
                dr = cfg.rec.d_rnn
                mix = 2 * d * dr + 2 * dr * dr + dr * d + cfg.rec.conv_width * dr
            elif kind == "rwkv":
                lora = max(32, d // 32)
                mix = 5 * d * d + d * lora + lora * d
            else:
                mix = 0.0
            if cfg.moe is not None and kind == "attn":
                m = cfg.moe
                expert = 3 * d * m.d_ff_expert
                routed_total = m.num_experts * expert
                routed_active = m.top_k * expert
                shared = 3 * d * m.d_ff_shared if m.d_ff_shared else 0.0
                router = d * m.num_experts
                ffn_total = routed_total + shared + router
                ffn_active = routed_active + shared + router
            else:
                ffn_total = ffn_active = 3 * d * ff
            total += rep * (mix + ffn_total)
            active += rep * (mix + ffn_active)
    return {"total": total, "active": active, "embed": float(embed)}


def model_flops_for(cfg, shape) -> float:
    """6*N_active*D for a train step; 2*N*D for prefill; 2*N*B for decode."""
    counts = param_counts(cfg)
    n = counts["active"]
    if shape.mode == "train":
        tokens = shape.global_batch * (shape.seq_len - cfg.frontend_tokens)
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * (shape.seq_len - cfg.frontend_tokens)
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
