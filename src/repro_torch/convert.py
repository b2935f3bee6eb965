"""State carried between numpy (the JAX package's and the arena's currency)
and torch tensors, byte for byte in both directions.

numpy has no bfloat16 of its own: the JAX package's bfloat16 arrays carry
an ``ml_dtypes`` type (kind ``"V"``, named ``bfloat16``), which the port
does not import.  On the host the port keeps a bfloat16 tensor's bytes as an
int16 array of the same shape (:func:`host_array`), and turns a 2-byte void
or ``bfloat16`` array, or an int16 array when told the tensor is bfloat16,
back into a bfloat16 tensor through a view, never a conversion.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def bf16_bits(a: np.ndarray) -> bool:
    """Whether a host array can hold bfloat16 bits: 2-byte integers (the
    port's host copy), or the JAX package's bfloat16 (kind "V")."""
    return a.dtype.itemsize == 2 and (a.dtype.kind in "iuV" or a.dtype.name == "bfloat16")


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a host numpy array of its shape: its own dtype,
    or for bfloat16 the int16 of the same bits.  Always a copy."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def to_tensor(a: Any, device: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` with the same bytes.

    A bfloat16 array of the JAX package (``ml_dtypes``) becomes a bfloat16
    tensor; so does a host copy made by :func:`host_array` (int16) when
    ``dtype`` is ``torch.bfloat16``.  Otherwise ``dtype`` is not used.
    """
    a = np.array(a, copy=True)
    if (a.dtype.kind == "V" or dtype == torch.bfloat16) and bf16_bits(a):
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def state_to_torch(state: Mapping[str, np.ndarray], device: str) -> Dict[str, torch.Tensor]:
    """Each leaf as a tensor on ``device`` with the same dtype, shape and bytes."""
    return {k: to_tensor(v, device) for k, v in state.items()}


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Each leaf as a host numpy array with the same shape and bytes (a
    bfloat16 leaf as int16, see :func:`host_array`)."""
    return {k: host_array(v) for k, v in state.items()}


def params_from_jax(tree: Mapping[str, Any], device: str) -> Dict[str, Any]:
    """The JAX package's parameter tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, init_params(...))`` gives it) as the port's,
    leaf for leaf and byte for byte."""
    return {
        k: params_from_jax(v, device) if isinstance(v, Mapping) else to_tensor(v, device)
        for k, v in tree.items()
    }


def train_state_from_jax(state: Mapping[str, Any], device: str) -> Dict[str, Any]:
    """The JAX package's train state (``init_train_state``'s tree: params,
    opt.mu, opt.nu, opt.count, step; numpy or jax arrays) as the port's, on
    ``device``, leaf for leaf and byte for byte."""
    host = lambda tree: {k: host(v) if isinstance(v, Mapping) else np.asarray(v)
                         for k, v in tree.items()}
    opt = state["opt"]
    return {
        "params": params_from_jax(host(state["params"]), device),
        "opt": {
            "mu": params_from_jax(host(opt["mu"]), device),
            "nu": params_from_jax(host(opt["nu"]), device),
            "count": to_tensor(np.asarray(opt["count"]), device),
        },
        "step": to_tensor(np.asarray(state["step"]), device),
    }
