# Port of repro/launch/mesh.py.  What differs:
# * A mesh is a torch DeviceMesh.  A host-only mesh ("single", "multi",
#   "tiny", "tiny-multi") lives on a fake process group of its world size,
#   this process being rank 0 (or the rank asked for): nothing is allocated
#   and no collective moves data, the counterpart of JAX's
#   --xla_force_host_platform_device_count.  Its tensors live on the
#   "meta" device.
# * A process has one default group, so building a mesh of another world
#   size tears down the group before it: a mesh built earlier stops being
#   usable.  Sweep meshes of one size at a time, or one process per mesh.
# * "h100" is one more name: the card itself as a 1 x 1 ("data", "model")
#   mesh on a one-rank NCCL group.
"""Production mesh definitions.

``make_production_mesh`` is a FUNCTION (not a module constant) so importing
this module never touches process-group state.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist


def _group(world: int, backend: str, rank: int = 0) -> None:
    """The default process group, re-created unless it already has this
    backend, world size and rank."""
    if dist.is_initialized():
        if (dist.get_backend() == backend and dist.get_world_size() == world
                and dist.get_rank() == rank):
            return
        dist.destroy_process_group()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)


def _mk(shape: Tuple[int, ...], axes: Tuple[str, ...], rank: int = 0):
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    _group(n, "fake", rank)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0):
    """16x16 (256 devices) or 2 x 16x16 = 512 devices with a "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, rank)


def make_tiny_mesh(*, multi_pod: bool = False, rank: int = 0):
    """CI-scale stand-in (8 devices): same axis structure, tiny extents."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, rank)


def make_h100_mesh():
    """The card as a 1 x 1 ("data", "model") mesh on a one-rank group."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device

    resolve_device("cuda")
    _group(1, "nccl")
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def mesh_for_name(name: str, rank: int = 0):
    if name == "single":
        return make_production_mesh(multi_pod=False, rank=rank)
    if name == "multi":
        return make_production_mesh(multi_pod=True, rank=rank)
    if name == "tiny":
        return make_tiny_mesh(multi_pod=False, rank=rank)
    if name == "tiny-multi":
        return make_tiny_mesh(multi_pod=True, rank=rank)
    if name == "h100":
        return make_h100_mesh()
    raise KeyError(f"unknown mesh {name!r}")


def tensor_device(mesh) -> str:
    """Where a mesh's local tensors live: "meta" on a host mesh."""
    return "meta" if mesh.device_type == "cpu" else mesh.device_type


def release() -> None:
    """Tear down the process group the meshes were built on."""
    if dist.is_initialized():
        dist.destroy_process_group()


MESH_DEVICE_COUNT = {"single": 256, "multi": 512, "tiny": 8, "tiny-multi": 8, "h100": 1}
