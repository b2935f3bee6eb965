# Port copy of repro/checkpoint/serialization.py, in the JAX package's
# on-disk format.  What differs:
# * A torch tensor leaf goes to the host through convert.host_array (a
#   bfloat16 tensor as the int16 of its bits); tree_nbytes counts a tensor
#   leaf without copying it.
# * A bfloat16 leaf (a bfloat16 tensor, or a 2-byte void or ml_dtypes
#   bfloat16 array) is written as its bits with the header descr '<V2' and
#   manifest dtype "bfloat16": byte for byte the file np.save writes for the
#   JAX package's ml_dtypes bfloat16 array.
# * load_pytree never calls np.dtype("bfloat16") (there may be no ml_dtypes):
#   a "bfloat16" leaf comes back as the 2-byte void array np.load gives,
#   which convert.to_tensor views as a bfloat16 tensor.
"""Pytree (de)serialization: one .npy per leaf + a JSON manifest.

Leaves are saved in *logical* (unsharded) layout; the format stays
mesh-agnostic so a checkpoint taken on any mesh restores onto any other.

Writes are durable: every leaf file is flushed+fsynced and the manifest —
which is what marks a checkpoint *complete* — is committed last through the
:mod:`repro_torch.core.durable` replace path.  A writer killed (or a node
losing power) mid-checkpoint therefore leaves either a manifest-less partial
the manager ignores, or a fully-landed checkpoint; never a manifest pointing
at torn leaf data.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..convert import host_array
from ..core.durable import durable_replace

_SEP = "/"
_BF16 = "bfloat16"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flatten_tree(v, prefix + k + _SEP))
            else:
                out[prefix + k] = v
    else:
        out[prefix.rstrip(_SEP) or "value"] = tree
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(_SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def tree_nbytes(tree: Any) -> int:
    """Total serialized payload size of a pytree's leaves, in bytes."""
    return sum(
        leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
        else np.asarray(leaf).nbytes
        for leaf in flatten_tree(tree).values()
    )


def _host_leaf(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf's host array and its manifest dtype; a bfloat16 leaf as the
    int16 of its bits."""
    if isinstance(leaf, torch.Tensor):
        arr = host_array(leaf)
        return arr, _BF16 if leaf.dtype == torch.bfloat16 else str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return arr.view(np.int16), _BF16
    return arr, str(arr.dtype)


def _write_npy(f, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(f, arr)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
    f.write(np.ascontiguousarray(arr).data)


def save_pytree(tree: Any, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    flat = flatten_tree(tree)
    manifest = {}
    for name, leaf in flat.items():
        arr, dtype = _host_leaf(leaf)
        safe = name.replace(_SEP, "__")
        with open(os.path.join(directory, safe + ".npy"), "wb") as f:
            _write_npy(f, arr, dtype)
            f.flush()
            os.fsync(f.fileno())
        manifest[name] = {"file": safe + ".npy", "shape": list(arr.shape), "dtype": dtype}
    tmp = os.path.join(directory, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    durable_replace(tmp, os.path.join(directory, "manifest.json"))


def load_pytree(directory: str) -> Any:
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for name, meta in manifest.items():
        arr = np.load(os.path.join(directory, meta["file"]))
        if meta["dtype"] == _BF16:
            want = np.dtype("V2")
            if arr.dtype != want:
                if arr.dtype.itemsize != 2:
                    raise ValueError(f"{name}: a bfloat16 leaf stored as {arr.dtype}")
                arr = arr.view(want)
        else:
            want = np.dtype(meta["dtype"])
            if arr.dtype != want:
                if arr.dtype.kind == "V" and arr.dtype.itemsize == want.itemsize:
                    arr = arr.view(want)
                else:
                    arr = arr.astype(want)
        flat[name] = arr
    return unflatten_tree(flat)
