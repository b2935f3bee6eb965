"""PyTorch/CUDA port of the EasyCrash reproduction.

Mirrors :mod:`repro`'s layout module for module, imports ``torch`` and numpy
and never ``jax`` or anything of the JAX package: host-layer modules that the
JAX package keeps in plain NumPy are copied here (see each file's header).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; see :mod:`repro_torch.device`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
