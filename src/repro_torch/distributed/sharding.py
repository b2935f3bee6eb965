# Port of repro/distributed/sharding.py.  What differs:
# * ShardingRules, DEFAULT_RULES, set_rules, get_rules and resolve are
#   copied unchanged; resolve returns the port's PartitionSpec, a tuple of
#   None, str or tuple[str, ...] (jax.sharding.PartitionSpec is a tuple of
#   the same).
# * A mesh is a torch DeviceMesh whose dim names are the mesh axes.
#   placements_for turns a spec into DTensor placements, one per mesh dim.
# * with_logical takes no mesh from a context: it returns x unchanged
#   unless x is a DTensor, whose own mesh it redistributes over.
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
    spec = get_rules().resolve(mesh.mesh_dim_names, *logical)
    return x.redistribute(mesh, placements_for(mesh, spec, x.ndim))


def named_sharding(mesh, *logical: Optional[str]):
    """(mesh, placements) of a tensor whose dims carry these logical axes."""
    return mesh, placements_for(mesh, spec_for(mesh, *logical), len(logical))


def spec_for(mesh, *logical: Optional[str]) -> P:
    return get_rules().resolve(mesh.mesh_dim_names, *logical)
