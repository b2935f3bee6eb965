# The port's counterpart of repro/launch/hlo_cost.py.  What differs:
# * There is no HLO.  The costs are counted from the aten ops that one step
#   runs eagerly on DTensors, by a TorchDispatchMode that sees each op on
#   the LOCAL shards (it defers every DTensor op, so DTensor runs it on the
#   local tensors, which the mode then counts).  Counting at the DTensor
#   level instead gives the global op: torch.utils.flop_counter over a
#   product sharded 8 ways counts its unsharded FLOPs.
# * Ops DTensor runs on fake tensors to propagate shapes, or on host
#   tensors of indices to place a strided shard, are not counted: only ops
#   whose tensors all lie where the local shards do.
# * FLOPs come only from matrix products and convolutions, 2 x |out| x K,
#   as hlo_cost counts dot and convolution.  (JAX's roofline takes the
#   larger of that and XLA's cost_analysis, which also counts elementwise
#   ops: on the CPU backend its decode cells count every bf16 operand's
#   conversion to f32, which is no work on the card.)
# * The port's own ops (torch.library custom ops, repro_torch::*) are one
#   op each, counted on their local shards by a rule of their work:
#   rwkv6_scan (and its plain-version op) 2 x B x S x H x D^2, hlo_cost's
#   count of the one dot in the step of JAX's lax.scan, times its S trips;
#   the backward of the plain version twice that (the dot's two
#   transposes); rglru_scan 0 (JAX's associative_scan has no dot);
#   flash_attention the two products over the (query, key) pairs its
#   causal window keeps, 4 x B x H x D per pair (S(S+1)/2 pairs without a
#   window), as chip_smoke.py's attn_bound_ms counts them.  Their bytes are
#   operands plus outputs, as for every op.
# * Bytes are operand plus output bytes of every aten op that is not a
#   view, a broadcast operand counted at the size it is stored at.  Eager runs no fusion, so this is an UPPER BOUND against XLA's
#   count, which charges a fusion only at its boundary.
# * Collective wire bytes come from the functional collectives the step
#   issues, each weighted by _collective_wire_bytes (copied from hlo_cost)
#   for its group's size; the group is the process group of the mesh dim
#   DTensor communicates over, and the record books each collective's wire
#   bytes to the mesh dims its group spans (collective_bytes_by_dim: "data",
#   or "pod+data" for a group DTensor flattened from two dims), so the
#   roofline can price each at the link its groups cross.
# * Eager unrolls every loop, so no trip count is recovered: the record's
#   trip_counts lists the loops the step ran (layers per group, and the
#   microbatches when it accumulates gradients), as the counts of JAX's
#   while loops.
"""Per-device FLOPs, memory traffic and collective traffic of one step,
counted from its aten ops on the local shards."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLL_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

#: ops that move no bytes: allocation, aliasing and collective bookkeeping
_NO_TRAFFIC = {
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::detach",
    "aten::alias", "aten::lift_fresh", "aten::_unsafe_view",
    "_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd",
}

_MATMULS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}


@dataclass
class OpCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0             # ring-weighted, per device
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    n_collectives: float = 0.0
    trip_counts: List[int] = field(default_factory=list)
    collective_bytes_by_dim: Dict[str, float] = field(default_factory=dict)


def _collective_wire_bytes(kind: str, nbytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * nbytes
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (g - 1) / g * nbytes
    return float(nbytes)


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dict views of an op's args."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list, type({}.values()))):
            stack.extend(x)
    return out


def _nbytes(x) -> int:
    """Bytes of the elements a tensor addresses: a broadcast (stride-0) dim
    counts once, as its storage is read once."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        if stride != 0:
            n *= size
    return n * x.element_size()


def _matmul_flops(name: str, args, out) -> float:
    a = args[1] if name in ("aten::addmm", "aten::baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out) -> float:
    w = args[1]
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


def _scan_flops(name: str, args) -> float:
    """The rule of one of the port's own ops, on its local shards."""
    op = name.partition("::")[2]
    if op in ("rwkv6_scan", "rwkv6_scan_ref"):
        b, s, h, d = args[0].shape
        return 2.0 * b * s * h * d * d
    if op == "rwkv6_scan_ref_backward":
        b, s, h, d = args[0].shape
        return 4.0 * b * s * h * d * d
    if op == "flash_attention":
        b, s, h, d = args[0].shape
        causal, window = args[3], args[4]
        if not causal:
            return 4.0 * b * h * d * s * s
        w = min(window, s) if window > 0 else s
        return 4.0 * b * h * d * (w * (w + 1) / 2 + (s - w) * w)
    return 0.0  # rglru_scan and its plain version and backward: no dot


def _group(group_name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name)


class OpCounter(TorchDispatchMode):
    """Counts one step's local FLOPs, bytes and collectives on ``mesh``
    into ``cost``: the ops whose tensors all lie on ``device``, where the
    local shards live ("meta" on a host mesh)."""

    def __init__(self, mesh, device: str):
        super().__init__()
        self.cost = OpCost()
        self.device = torch.device(device).type
        self.last_dtensor_op = None  # the op DTensor dispatched last: names a failure
        self._mesh = mesh
        self._dims_of: Dict[str, str] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.last_dtensor_op = func
            return NotImplemented  # DTensor runs it on the local shards, counted below
        out = func(*args, **kwargs)
        leaves = _tensors((args, kwargs.values(), out))
        if any(isinstance(x, FakeTensor) or x.device.type != self.device for x in leaves):
            return out  # DTensor's shape propagation or index bookkeeping, not the step's
        self._count(func, args, out, leaves)
        return out

    def _count(self, func, args, out, leaves) -> None:
        name = func._schema.name  # the op, whatever its overload
        c = self.cost
        ns, _, op = name.partition("::")
        if name in _MATMULS:
            c.flops += _matmul_flops(name, args, out)
        elif name == "aten::convolution":
            c.flops += _conv_flops(args, out)
        elif ns == "repro_torch":
            c.flops += _scan_flops(name, args)
        if ns == "_c10d_functional" and op in _COLL_KINDS:
            kind = _COLL_KINDS[op]
            group_name = args[-1]
            dim = self._dims(group_name)
            nbytes = sum(_nbytes(x) for x in _tensors(out))
            wire = _collective_wire_bytes(kind, nbytes, _group(group_name).size())
            c.collective_bytes += wire
            c.collective_breakdown[kind] = c.collective_breakdown.get(kind, 0.0) + wire
            c.collective_bytes_by_dim[dim] = c.collective_bytes_by_dim.get(dim, 0.0) + wire
            c.n_collectives += 1
        if func.is_view or name in _NO_TRAFFIC:
            return
        c.bytes_accessed += sum(_nbytes(x) for x in leaves)

    def _dims(self, group_name: str) -> str:
        """The mesh dims a group spans, "+"-joined ("data", or "pod+data"
        for a group DTensor flattened from two dims)."""
        if group_name not in self._dims_of:
            import torch.distributed as dist

            ranks = dist.get_process_group_ranks(_group(group_name))
            grid = self._mesh.mesh
            coords = [(grid == r).nonzero()[0].tolist() for r in ranks]
            names = self._mesh.mesh_dim_names
            self._dims_of[group_name] = "+".join(
                names[i] for i in range(grid.ndim) if len({c[i] for c in coords}) > 1)
        return self._dims_of[group_name]
