"""Bytes the heat solver's iteration needs (``bench/configs/heat-32768.json``)."""
from __future__ import annotations

from typing import Dict


def heat_iter_bytes(grid: int, itemsize: int = 4) -> int:
    """Bytes one heat iteration needs: the temperature field read once and
    written once, the flux diagnostic written once: ``3 * grid**2 * 4``.
    The iteration's ``steps_per_iter`` explicit steps could be fused into
    one pass over the field, so they count once; the pins are
    negligible."""
    return 3 * grid * grid * itemsize


def iter_bytes(config: Dict) -> int:
    return heat_iter_bytes(int(config["app_args"]["grid"]))
