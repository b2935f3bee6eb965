# The port's copy of the part of jax.random that montecarlo draws from:
# jax 0.9.0's default threefry PRNG with jax_threefry_partitionable on.
# What differs from JAX:
# * Words are int64 tensors holding 32-bit values (masked after every add
#   and shift): torch's uint32 lacks shifts and adds on some backends, and
#   int32 has no logical right shift.  The bits and the uniforms are JAX's
#   bit for bit, on the CPU and the card alike.
# * normal() is sqrt(2) * erfinv(u), with erfinv XLA's float32 polynomial
#   (ErfInv32) and its log1p XLA's CPU one: a Cephes rational function where
#   |x| < sqrt(2) - 1, else a Cephes logf of 1 + x.  Every multiply-add that
#   XLA contracts is one torch.addcmul (one rounding).  That gives JAX's
#   floats for all but about 1 in 30,000 elements (a few ulp off, in the
#   logf branch), so normal() is held to JAX's within a few ulp, not to the
#   bit.  torch.erfinv and torch.log1p are not used: they differ from XLA's
#   in the last bit for most, or for 8 %, of the floats.
"""Counter-based threefry-2x32 random numbers, as ``jax.random`` makes them.

Keys are pairs of Python ints (k0, k1), each below 2**32, or pairs of 0-d
int64 tensors holding such values (a key folded from a tensor).  Every element of
an output depends only on the key and its flat index, so a caller may draw a
large array in pieces (``offset``) and get the same bits as one draw.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: XLA's ErfInv32 coefficients (xla/client/lib/math.cc, also
#: stablehlo's ChloLegalizeToStablehlo.cpp materializeErfInvF32), highest
#: power first: on w - 2.5 where w < 5, on sqrt(w) - 3 elsewhere
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (as XLA's and the card's):
    taken in float64 and rounded once, which is exact for a square root.
    torch's CPU float32 sqrt is not correctly rounded everywhere."""
    return torch.sqrt(x.double()).float()


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=like.device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under the key
    (k0, k1); x0 and x1 are int64 tensors of 32-bit values."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``: threefry of the counter (0, data).

    For an int ``data`` the key is a pair of ints; for a 0-d integer tensor
    it is a pair of 0-d int64 tensors on that tensor's device (the same
    bits), which every function here takes in an int key's place."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _MASK
        return threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK], dtype=torch.int64))
    return int(x0[0]), int(x1[0])


def random_bits(key: Key, n: int, device: str = "cpu", offset: int = 0) -> torch.Tensor:
    """Elements ``offset .. offset + n - 1`` of the flat uint32 stream of
    ``jax.random.bits(key, shape)`` (partitionable layout: element i is
    b0 ^ b1 of threefry over (i >> 32, i & 0xFFFFFFFF)), as int64."""
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    return b0 ^ b1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as a float32 in [1, 2), minus 1: [0, 1) (JAX's
    construction: exponent of 1.0 or'd onto the mantissa bits)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
            device: str = "cpu", offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)``; ``offset`` skips
    that many flat elements of the stream (for drawing in pieces)."""
    n = math.prod(shape)
    unit = _bits_to_unit(random_bits(key, n, device, offset))
    lo_t = _c(lo, unit)
    span = _c(hi, unit) - lo_t
    # jit contracts unit * span + lo; span is a power of two for the ranges
    # used here, so one rounding and two give the same bits
    return torch.maximum(lo_t, torch.addcmul(lo_t, unit, span)).reshape(tuple(shape))


#: XLA's log1p for |x| < sqrt(2) - 1 (ElementalIrEmitter::EmitLog1p, after
#: Cephes): x + (-x^2/2 + x^3 * P(x) / Q(x)), highest power last
_LOG1P_P = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1, 6.5787325942061044846969E0,
            2.9911919328553073277375E1, 6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)
_LOG1P_Q = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
            2.2176239823732856465394E2, 3.0909872225312059774938E2,
            2.1642788614495947685003E2, 6.0118660497603843919306E1)
#: Cephes logf, as XLA's CPU backend emits it (polynomial_approximations.cc)
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
           1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
           3.3333331174E-1)


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = torch.full_like(x, float(np.float32(coefs[0])))
    for c in coefs[1:]:
        p = torch.addcmul(_c(c, x), p, x)
    return p


def _logf_cephes(a: torch.Tensor) -> torch.Tensor:
    """Cephes logf of a positive float32 tensor, XLA's steps and roundings."""
    ma = lambda x, y, acc: torch.addcmul(acc, x, y)  # noqa: E731
    a = torch.maximum(a, _c(1.1754944e-38, a))  # the smallest normal
    bits = a.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = t < _c(0.707106781186547524, a)
    e = e - low.float()
    t = (t - 1.0) + torch.where(low, t, _c(0.0, a))
    x2 = t * t
    x3 = x2 * t
    p = _LOGF_P
    y = ma(ma(t, _c(p[0], a), _c(p[1], a)), t, _c(p[2], a))
    y1 = ma(ma(t, _c(p[3], a), _c(p[4], a)), t, _c(p[5], a))
    y2 = ma(ma(t, _c(p[6], a), _c(p[7], a)), t, _c(p[8], a))
    y = ma(ma(y, x3, y1), x3, y2) * x3
    y = ma(_c(-2.12194440e-4, a), e, y)
    t = ma(_c(-0.5, a), x2, t) + y
    return ma(_c(0.693359375, a), e, t)


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p on the CPU, for x > -1."""
    x2 = x * x
    small = x + torch.addcmul((x * x2) * (_horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q)),
                              _c(-0.5, x), x2)
    return torch.where(x.abs() < _c(0.41421356237309504880, x), small,
                       _logf_cephes(x + 1.0))


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function on a float32 tensor."""
    w = -log1p_xla(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    coef = [torch.where(lt, _c(a, x), _c(b, x)) for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = torch.addcmul(c, p, w)
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


_NEXT_BELOW_ZERO_FROM_MINUS_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: Key, shape: Sequence[int], device: str = "cpu", offset: int = 0
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) * erfinv(u) for u
    uniform in (-1, 1), to a few ulp of JAX's."""
    u = uniform(key, shape, _NEXT_BELOW_ZERO_FROM_MINUS_ONE, 1.0, device, offset)
    return erfinv_xla(u) * float(np.float32(np.sqrt(2.0)))
