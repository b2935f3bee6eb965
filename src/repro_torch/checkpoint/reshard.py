# Port of repro/checkpoint/reshard.py.  What differs:
# * A mesh is a torch DeviceMesh and a placed leaf a DTensor: each host
#   leaf goes through distribute_tensor on the mesh's device type with
#   src_data_rank=None, so every rank slices its own shard of the host
#   array it holds and nothing is scattered.  A bfloat16 leaf (the 2-byte
#   void array load_pytree gives) becomes a bfloat16 tensor of its bits
#   (convert.to_tensor).
# * The trees pair by key (a dict's keys, wherever they sit), never by leaf
#   order: the port walks dicts in insertion order, jax.tree sorts keys.
"""Elastic restore: load a mesh-agnostic checkpoint onto any mesh.

Checkpoints store logical (unsharded) arrays, so resharding is just placing
each one with the *target* mesh's placements.  This is the elastic-scaling
path: a run checkpointed on N hosts restores onto M hosts with a different
mesh shape (DTensor splits a dim that does not divide unevenly, as torch.chunk
does).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..convert import to_tensor
from ..distributed.sharding import get_rules, placements_for


def reshard_restore(tree: Any, spec_tree: Any, mesh) -> Any:
    """Place a host-memory tree onto ``mesh`` per logical spec tree.

    ``spec_tree`` mirrors ``tree`` with tuples of logical axis names (the
    same trees the model exposes via ``param_specs``/``cache_specs``).
    """
    from torch.distributed.tensor import distribute_tensor

    rules = get_rules()

    def place(leaf, spec):
        if spec is None:
            spec = ()
        pspec = rules.resolve(mesh.mesh_dim_names, *spec)
        host = to_tensor(np.asarray(leaf), mesh.device_type)
        return distribute_tensor(host, mesh, placements_for(mesh, pspec, host.ndim),
                                 src_data_rank=None)

    def walk(t, s, path):
        if isinstance(t, dict):
            if not isinstance(s, dict) or set(t) != set(s):
                raise ValueError(f"spec tree at {path or '<root>'} does not match the tree's keys")
            return {k: walk(t[k], s[k], f"{path}/{k}") for k in t}
        return place(t, s)

    return walk(tree, spec_tree, "")
