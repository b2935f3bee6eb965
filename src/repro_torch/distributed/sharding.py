# Port of repro/distributed/sharding.py.  What differs:
# * ShardingRules, DEFAULT_RULES, set_rules, get_rules and resolve are
#   copied unchanged; resolve returns the port's PartitionSpec, a tuple of
#   None, str or tuple[str, ...] (jax.sharding.PartitionSpec is a tuple of
#   the same).
# * A mesh is a torch DeviceMesh whose dim names are the mesh axes.
#   placements_for turns a spec into DTensor placements, one per mesh dim.
# * with_logical takes no mesh from a context: it returns x unchanged
#   unless x is a DTensor, whose own mesh it redistributes over.  A dim
#   its mesh axes do not divide stays replicated, and those axes stay free
#   for the dims after it (XLA pads such a dim instead; DTensor's views
#   cannot reshape an uneven shard, as a batch of 1 over "data" would be).
#   So 60 experts over a 16-way "model" leave "model" to expert_ff.
# * Heads are the one such dim the port pads as XLA does: a mesh whose
#   "model" axis does not divide a model's heads (40 or 24 over 16) gets
#   its parameters padded to whole heads per device (models/padding.py),
#   so heads_split and heads_merged view an even split as it lies and
#   refuse one that would cut a head.  The kv heads are not padded (their
#   specs replicate them where the axis does not divide them): their
#   heads_split(..., gather=True) gathers such a split.
# * named_sharding returns (mesh, placements): there is no NamedSharding
#   object.
"""Logical-axis sharding rules (MaxText-style) for the production meshes.

Model code annotates tensors with *logical* axis names; the active
:class:`ShardingRules` maps them to mesh axes.  Baseline mapping:

  batch   -> ("pod", "data")     activations' batch dim
  seq     -> "model"             sequence-parallel activations between blocks
  vocab   -> "model"             embedding/logit vocab dim
  heads   -> "model"             attention-head tensor parallelism
  ff      -> "model"             MLP hidden tensor parallelism
  experts -> "model"             expert parallelism (MoE, when divisible)
  fsdp    -> ("pod", "data")     ZeRO-3 sharding of params/moments
  kv_seq  -> "model"             decode KV-cache sequence sharding (GQA<TP)

Anything unmapped is replicated.  ``with_logical`` is the model-side
constraint helper; it is a no-op on a plain tensor (single-device runs take
the same code).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names (the dim split over all of them, major
    first)."""

    def __new__(cls, *axes: Axis) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, Axis], ...] = (
        ("batch", ("pod", "data")),
        ("seq", "model"),
        ("vocab", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("ff", "model"),
        ("experts", "model"),
        ("expert_ff", "model"),
        ("fsdp", ("pod", "data")),
        ("kv_seq", "model"),
        ("rnn", "model"),
    )

    def resolve(self, mesh_axes: Sequence[str], *logical: Optional[str]) -> P:
        """Translate logical names to a PartitionSpec valid on this mesh."""
        table = dict(self.rules)
        out = []
        used: set = set()
        for name in logical:
            if name is None:
                out.append(None)
                continue
            ax = table.get(name)
            if ax is None:
                out.append(None)
                continue
            if isinstance(ax, str):
                ax = (ax,)
            ax = tuple(a for a in ax if a in mesh_axes and a not in used)
            used.update(ax)
            if not ax:
                out.append(None)
            elif len(ax) == 1:
                out.append(ax[0])
            else:
                out.append(ax)
        return P(*out)

    def replace(self, **kw: Axis) -> "ShardingRules":
        table = dict(self.rules)
        table.update(kw)
        return ShardingRules(tuple(table.items()))


DEFAULT_RULES = ShardingRules()

# A context-global rules object: launch code swaps it before a run.
_active_rules = DEFAULT_RULES


def set_rules(rules: ShardingRules) -> None:
    global _active_rules
    _active_rules = rules


def get_rules() -> ShardingRules:
    return _active_rules


def placements_for(mesh, spec: Sequence[Axis], ndim: int) -> List:
    """DTensor placements, one per mesh dim, for a tensor of rank ``ndim``
    sharded by ``spec`` (shorter than ``ndim``: the rest replicated).

    A tensor dim split over several mesh axes becomes ``Shard(dim)`` on each
    of their mesh dims.  DTensor splits a dim over its mesh dims in mesh-dim
    order, the first one major, so the axes of such an entry must follow the
    mesh's order for the shards to be JAX's (the default rules' ("pod",
    "data") does on every mesh here).  A mesh dim of size 1 stays
    ``Replicate()``: its one shard is the whole dim either way, and a
    replicated dim keeps DTensor's views free to merge it (torch 2.11's
    cannot flatten a sharded dim, as every product on the card's 1 x 1 mesh
    would).
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the tensor's {ndim} dims")
    out: List = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of spec {tuple(spec)}")
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return out


def with_logical(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Sharding constraint by logical axis names (no-op on a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules, spec = get_rules(), []
    for n, name in zip(x.shape, logical):
        # resolve one dim at a time, so an axis a dim cannot take (it does
        # not divide it) stays free for the dims after it
        used = [a for ax in spec if ax for a in ((ax,) if isinstance(ax, str) else ax)]
        ax = rules.resolve([a for a in mesh.mesh_dim_names if a not in used], name)[0]
        split = 1
        for a in ((ax,) if isinstance(ax, str) else ax or ()):
            split *= sizes[a]
        spec.append(ax if n % split == 0 else None)
    return x.redistribute(mesh, placements_for(mesh, spec, x.ndim))


def _split(x: torch.Tensor, dim: int) -> int:
    """Into how many shards a DTensor splits ``dim`` (1 for a plain
    tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return 1
    n = 1
    for p, size in zip(x.placements, x.device_mesh.shape):
        if isinstance(p, Shard) and p.dim == dim % x.ndim:
            n *= size
    return n


def is_dtensor(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor (placed on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def is_sharded(x: torch.Tensor, dim: int) -> bool:
    """Whether ``x`` is a DTensor split along ``dim`` (False for a plain
    tensor)."""
    return _split(x, dim) > 1


def gathered(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` whole along ``dim`` on every device, its other dims split as
    they were (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Shard) and p.dim == dim
                                          else p for p in x.placements])


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient brought to x's placements in the
    backward (a redistribution to the placements it has)."""
    from torch.distributed.tensor import DTensor

    return x.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else x


def _whole_heads(x: torch.Tensor, dim: int, n_heads: int, gather: bool) -> torch.Tensor:
    """``x`` with its split of ``dim`` (``n_heads`` heads) holding whole
    heads: a split that would cut a head is gathered where ``gather`` (the
    kv heads, which are not padded: their specs replicate them where the
    axis does not divide them), and refused otherwise, since such heads
    are padded to the split (models/padding.py), as XLA pads them."""
    split = _split(x, dim)
    if n_heads % split == 0:
        return x
    if gather:
        return gathered(x, dim)
    raise ValueError(f"{n_heads} heads split {split} ways would cut a head: pad the heads "
                     "to the split (models/padding.py pad_params)")


def heads_split(x: torch.Tensor, n_heads: int, d_head: int, gather: bool = False
                ) -> torch.Tensor:
    """(..., n_heads * d_head) -> (..., n_heads, d_head), each shard of a
    DTensor holding whole heads (a split that would cut one is gathered if
    ``gather``, else refused); the result keeps its placements in the
    backward too, so a gradient that comes back split otherwise over the
    heads is never viewed back."""
    x = _whole_heads(x, -1, n_heads, gather)
    return _pinned(x.reshape(*x.shape[:-1], n_heads, d_head))


def heads_merged(x: torch.Tensor) -> torch.Tensor:
    """(..., H, D) -> (..., H * D), the inverse of :func:`heads_split`: a
    split of the heads must hold whole heads, and the result keeps its
    placements in the backward."""
    x = _whole_heads(x, -2, x.shape[-2], gather=False)
    return _pinned(x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]))


def named_sharding(mesh, *logical: Optional[str]):
    """(mesh, placements) of a tensor whose dims carry these logical axes."""
    return mesh, placements_for(mesh, spec_for(mesh, *logical), len(logical))


def spec_for(mesh, *logical: Optional[str]) -> P:
    return get_rules().resolve(mesh.mesh_dim_names, *logical)


@functools.cache
def register_op_strategies() -> None:
    """Teach DTensor the port's own ops and the MoE router's scatter_reduce
    (run once; DTensor keeps the rules for the process).

    Each rule lists, per mesh dim, the placements an op runs under with no
    communication: everything replicated, or split along a dim the op works
    on independently.  The scans and flash_attention split over batch and
    over heads (rglru_scan over channels); the sequence stays whole.
    scatter_reduce splits along any dim but the one it scatters along.
    """
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    from ..kernels.flash_attention import ops as _fa  # noqa: F401  (defines the ops)
    from ..kernels.rglru_scan import ops as _rg  # noqa: F401
    from ..kernels.rwkv6_scan import ops as _rw  # noqa: F401

    ops, R, S = torch.ops.repro_torch, Replicate(), Shard

    @register_sharding([ops.rwkv6_scan.default, ops.rwkv6_scan_ref.default])
    def _rwkv(r, k, v, w, u, return_state):
        # (y, S) <- (r, k, v, w, u, return_state)
        return [([R, R], [R] * 5 + [None]),
                ([S(0), S(0)], [S(0)] * 4 + [R, None]),
                ([S(2), S(1)], [S(2)] * 4 + [S(0), None])]

    @register_sharding(ops.rwkv6_scan_ref_backward.default)
    def _rwkv_bwd(r, k, v, w, u, dy, dS):
        # (dr, dk, dv, dw, du per sequence) <- (r, k, v, w, u, dy, dS)
        return [([R] * 5, [R] * 7),
                ([S(0)] * 5, [S(0)] * 4 + [R, S(0), S(0)]),
                ([S(2)] * 4 + [S(1)], [S(2)] * 4 + [S(0), S(2), S(1)])]

    @register_sharding([ops.rglru_scan.default, ops.rglru_scan_ref.default])
    def _rglru(a, b):
        return [([p], [p, p]) for p in (R, S(0), S(2))]

    @register_sharding(ops.rglru_scan_ref_backward.default)
    def _rglru_bwd(a, b, dh):
        return [([p, p], [p, p, p]) for p in (R, S(0), S(2))]

    @register_sharding(ops.flash_attention.default)
    def _flash(q, k, v, causal, window, block_k, scale=None):
        return [([p], [p, p, p, None, None, None, None]) for p in (R, S(0), S(2))]

    @register_sharding(torch.ops.aten.scatter_reduce.two)
    def _scatter_reduce(self, dim, index, src, reduce, include_self=True):
        # out <- (self, dim, index, src, reduce, include_self)
        dim %= len(self.shape)
        dims = [d for d in range(len(self.shape))
                if d != dim and self.shape[d] == index.shape[d] == src.shape[d]]
        return [([p], [p, None, p, p, None, None]) for p in [R] + [S(d) for d in dims]]
