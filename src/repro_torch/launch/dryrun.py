# Port of repro/launch/dryrun.py.  What differs:
# * No XLA: a cell runs its step ONCE, eagerly, on DTensors over the named
#   mesh (launch/mesh.py).  On a host mesh the mesh is a fake process group
#   and every local shard is an empty tensor on the "meta" device, so
#   nothing is allocated and no collective moves data; on "h100" the shards
#   are zero-filled tensors on the card and the step really runs.
#   launch/op_cost.py counts the step's aten ops on the local shards
#   (FLOPs, bytes, collectives), launch/analysis.py turns the counts into
#   roofline terms with H100 data-sheet rates.
# * The peak of device memory is a MemTracker's peak over the placed inputs
#   and the step on a host mesh, and torch.cuda.max_memory_allocated on
#   "h100"; the eager train step keeps the old and the new state alive
#   together (no donation), so its peak is the port's, not XLA's.
#   fits_16gb_hbm (a v5e chip) becomes fits_80gb_hbm (an H100).
# * lower_s is the time to place the inputs on the mesh and compile_s the
#   counted step's wall time (there is no lowering and no compile).
# * Trees pair with their spec trees by key (_zip_map), never by leaf order.
# * Heads that the "model" axis does not divide (40 over 16 for
#   Llama-4-Scout and RWKV6-3B, 24 for musicgen-medium) are padded to the
#   split in the placed parameters and caches (models/padding.py): the
#   abstract trees are built for the padded head count, so each device
#   holds whole heads (3 of 48, 2 of 32), as XLA pads them in JAX's step.
# * A three-axis mesh whose rules use "pod" only as ("pod", "data") (the
#   default rules' batch and fsdp) runs the step on a two-axis view of the
#   same ranks, its "data" the flattened (pod, data) (_step_mesh): the
#   same shards, and DTensor's own ranking of its strategies, which over
#   three axes takes minutes per op, is as quick as on "single".  The
#   counter still books each collective to the dims of the named mesh
#   ("pod+data" for the flattened axis), so the roofline prices the pod
#   links apart.
# * A recurrent scan is one op: the model calls the torch.library custom
#   op of its scan (repro_torch::rwkv6_scan_ref / ::rglru_scan_ref under
#   impl="reference", with one backward op in a train step), which DTensor
#   runs per shard by the rule of distributed/sharding.py
#   (register_op_strategies, called by cell) and op_cost.py counts by its
#   rule, where JAX's HLO holds a while loop of S trips and hlo_cost
#   multiplies its body.
# * --impl kernel is JAX's --impl pallas: on "h100" the step runs the CUDA
#   kernels (rwkv6_scan, rglru_scan, flash_attention) through their ops on
#   the card's local tensors; on a host mesh the ops' fakes stand in.
# * A DTensor op with no sharding strategy raises inside the step: the cell
#   records status "error" with the op's name, as JAX records a failed
#   compile, and the sweep goes on.  Nothing falls back to a replicated or
#   unsharded count.
"""Multi-pod dry-run: run every (arch x shape x mesh) cell once on a mesh of
fake devices and count what one step costs each device.

For each cell this driver:

  1. builds the mesh (16x16 single pod / 2x16x16 multi-pod / the CI-sized
     tiny meshes, on a fake process group; or "h100", the card);
  2. resolves the model's logical shard specs against it, the heads padded
     to the "model" axis and any other dim a mesh axis does not divide
     replicated;
  3. runs the step once on DTensors whose local shards are meta tensors — no
     allocation;
  4. records the per-device FLOPs, bytes and collective traffic, the peak of
     device memory, and the three roofline terms into one JSON per cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \
      --mesh single,multi --out build/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import ARCHS, get_arch
from ..distributed.sharding import get_rules, placements_for, register_op_strategies
from ..models import SHAPES, cache_specs, get_shape, param_specs, shape_applicable
from ..models.config import ModelConfig, ShapeConfig
from .analysis import model_flops_for, param_counts, roofline_from_counts
from .mesh import mesh_for_name, tensor_device
from .op_cost import OpCounter
from .steps import (
    abstract_cache,
    abstract_params,
    abstract_train_state,
    input_spec_names,
    input_specs,
    make_decode_fn,
    make_prefill_step,
    make_train_step,
    train_state_specs,
)

#: an H100's device memory, bytes
HBM_BYTES = 80e9


def _zip_map(fn, spec_tree, tree, path: str = ""):
    """fn(spec, leaf) over two trees paired by dict key; a spec leaf is a
    tuple."""
    if isinstance(tree, dict):
        if not isinstance(spec_tree, dict) or set(tree) != set(spec_tree):
            raise ValueError(f"spec tree at {path or '<root>'} does not match the tree's keys")
        return {k: _zip_map(fn, spec_tree[k], tree[k], f"{path}/{k}") for k in tree}
    return fn(spec_tree, tree)


def _resolve_tree(mesh, spec_tree, abstract_tree):
    """Logical specs -> DTensor placements, pruning axes that don't divide.

    Argument shardings must divide the dimension exactly, as JAX's do; a
    dim like batch=1 that its axes do not divide falls back to replication
    on that dim (the heads come padded to the "model" axis: _run_step).
    """
    rules = get_rules()
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))

    def leaf(spec, aval):
        pspec = rules.resolve(names, *spec)
        pruned = []
        for dim, ax in zip(aval.shape, tuple(pspec) + (None,) * (aval.ndim - len(pspec))):
            if ax is None:
                pruned.append(None)
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            total = 1
            for a in axes:
                total *= sizes.get(a, 1)
            pruned.append(ax if dim % total == 0 else None)
        return placements_for(mesh, pruned, aval.ndim)

    return _zip_map(leaf, spec_tree, abstract_tree)


def _place(mesh, spec_tree, abstract_tree):
    """Each abstract leaf as a DTensor on ``mesh``: its local shard an empty
    meta tensor on a host mesh, zeros on the card."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dev = tensor_device(mesh)
    real = dev != "meta"
    placements = _resolve_tree(mesh, spec_tree, abstract_tree)

    def leaf(pl, aval):
        shape, _ = compute_local_shape_and_global_offset(aval.shape, mesh, pl)
        if real:
            local = torch.zeros(shape, dtype=aval.dtype, device=dev)
        else:
            local = torch.empty(shape, dtype=aval.dtype, device=dev)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=aval.shape,
                                  stride=aval.stride())

    return _zip_map(leaf, placements, abstract_tree)


def _step_mesh(mesh):
    """The mesh the step runs on: ``mesh`` itself, or for ("pod", "data",
    "model") under rules that name "pod" only in ("pod", "data"), a
    ("data", "model") mesh over the same ranks whose "data" is the
    flattened pair (rank p * D * M + d * M + m at (p * D + d, m): the same
    shards as the two axes give, pod major)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(mesh.mesh_dim_names)
    pairs = [ax for _, ax in get_rules().rules
             if ax is not None and {"pod", "data"} & set((ax,) if isinstance(ax, str) else ax)]
    if names != ("pod", "data", "model") or any(ax != ("pod", "data") for ax in pairs):
        return mesh
    grid = mesh.mesh.reshape(-1, mesh.shape[-1])
    return DeviceMesh(mesh.device_type, grid, mesh_dim_names=("data", "model"))


def _trip_counts(cfg: ModelConfig, shape: ShapeConfig) -> list:
    trips = [rep for _, rep in cfg.groups]
    if shape.mode == "train" and cfg.grad_accum > 1:
        trips.append(cfg.grad_accum)
    return sorted(trips)


def _run_step(cfg: ModelConfig, shape: ShapeConfig, mesh, impl: str, counter: OpCounter):
    """Place the cell's inputs on ``mesh`` and run its step once, under
    ``counter`` (the placing is not the step's work).  Returns (seconds to
    place, seconds of the step)."""
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    t0 = time.perf_counter()
    if shape.mode == "train":
        step = make_train_step(cfg, impl=impl)
        args = (_place(mesh, train_state_specs(cfg, tp), abstract_train_state(cfg, tp)),
                _place(mesh, input_spec_names(cfg, shape), input_specs(cfg, shape)))
    elif shape.mode == "prefill":
        step = make_prefill_step(cfg, impl=impl)
        args = (_place(mesh, param_specs(cfg, tp), abstract_params(cfg, tp)),
                _place(mesh, input_spec_names(cfg, shape), input_specs(cfg, shape)))
    else:  # decode
        step = make_decode_fn(cfg)
        tok = input_specs(cfg, shape)["token"]
        args = (_place(mesh, param_specs(cfg, tp), abstract_params(cfg, tp)),
                _place(mesh, cache_specs(cfg, tp), abstract_cache(cfg, shape, tp)),
                _place(mesh, {"token": ("batch", None)}, {"token": tok})["token"])
    t_place = time.perf_counter() - t0
    with torch.set_grad_enabled(shape.mode == "train"), counter:
        out = step(*args)
    if mesh.device_type != "cpu":
        torch.cuda.synchronize()
    del out, args
    return t_place, time.perf_counter() - t0 - t_place


class CellError(RuntimeError):
    """A step that failed on the mesh, with the DTensor op it failed in."""


def cell(cfg: ModelConfig, shape: ShapeConfig, mesh, impl: str = "reference") -> Dict[str, Any]:
    """Count one step of ``cfg`` at ``shape`` on ``mesh``: the result record
    of run_cell from "lower_s" on.  A failing step raises CellError naming
    the last DTensor op dispatched."""
    from torch.distributed.tensor.experimental import implicit_replication

    register_op_strategies()
    step_mesh = _step_mesh(mesh)
    counter = OpCounter(mesh, tensor_device(mesh))
    counter.cost.trip_counts = _trip_counts(cfg, shape)
    if mesh.device_type == "cpu":
        from torch.distributed._tools.mem_tracker import MemTracker

        tracker = MemTracker()
        try:
            with tracker, implicit_replication():
                t_place, t_step = _run_step(cfg, shape, step_mesh, impl, counter)
        except Exception as e:
            raise CellError(f"{type(e).__name__}: {e} (in {counter.last_dtensor_op})") from e
        peak = tracker.get_tracker_snapshot("peak")
        mem = {"peak_hbm_bytes": float(sum(d["Total"] for d in peak.values()))}
    else:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            with implicit_replication():
                t_place, t_step = _run_step(cfg, shape, step_mesh, impl, counter)
        except Exception as e:
            raise CellError(f"{type(e).__name__}: {e} (in {counter.last_dtensor_op})") from e
        mem = {"peak_hbm_bytes": float(torch.cuda.max_memory_allocated() - base)}
    n_dev = mesh.size()
    terms = roofline_from_counts(counter.cost, n_dev, model_flops_for(cfg, shape), mesh,
                                 memory_stats=mem)
    return {
        "lower_s": round(t_place, 1),
        "compile_s": round(t_step, 1),
        "n_devices": n_dev,
        "param_counts": param_counts(cfg),
        "roofline": terms.as_dict(),
        "collective_bytes_by_dim": dict(counter.cost.collective_bytes_by_dim),
        "bytes_per_device": mem["peak_hbm_bytes"],
        "fits_80gb_hbm": bool(mem["peak_hbm_bytes"] <= HBM_BYTES),
    }


def run_cell(arch: str, shape_name: str, mesh_name: str, impl: str = "reference",
             moe_groups: int = 1, grad_accum: Optional[int] = None) -> Dict[str, Any]:
    cfg = get_arch(arch)
    if moe_groups > 1 and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=moe_groups)
        )
    if grad_accum is not None:
        cfg = dataclasses.replace(cfg, grad_accum=grad_accum)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": shape.mode, "status": "skipped", "reason": reason,
    }
    if not ok:
        return result
    try:
        result.update(status="ok", **cell(cfg, shape, mesh_for_name(mesh_name), impl))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        msg = str(e) if isinstance(e, CellError) else f"{type(e).__name__}: {e}"
        result.update(status="error", error=msg, traceback=traceback.format_exc()[-2000:])
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--impl", default="reference")
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    os.makedirs(args.out, exist_ok=True)

    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"{arch}_{shape}_{mesh}".replace("/", "-")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                res = run_cell(arch, shape, mesh, impl=args.impl,
                               moe_groups=args.moe_groups,
                               grad_accum=args.grad_accum or None)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] == "ok":
                    r = res["roofline"]
                    print(
                        f"[ok]   {tag}: compile={res['compile_s']}s "
                        f"dominant={r['dominant']} compute={r['compute_s']:.3e}s "
                        f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
                        f"useful={r['useful_ratio']:.2f}", flush=True
                    )
                elif res["status"] == "skipped":
                    print(f"[skip] {tag}: {res['reason']}", flush=True)
                else:
                    print(f"[ERR]  {tag}: {res['error']}", flush=True)


if __name__ == "__main__":
    main()
