"""What the metric readers share: means over the window's units, the
traced run's kernel shares.  Host-clock means leave out the units that ran
under the profiler."""
from __future__ import annotations

from typing import Dict, Optional

from bench import counts
from bench.trace import kernel_seconds

DELTA_KERNELS = ("dirty_vec16_kernel", "dirty_scalar_kernel")


def untraced_mean_ms(rec: Dict, key: str) -> Optional[float]:
    vals = [u[key] for u in rec.get("units", []) if key in u and not u["traced"]]
    return 1e3 * sum(vals) / len(vals) if vals else None


def delta_roofline(rec: Dict) -> Optional[float]:
    """Byte bound of the traced delta flushes' masks over the mask kernels'
    device time, in %."""
    trace = rec.get("trace")
    flushes = [u for u in rec.get("units", []) if u["traced"] and "launches" in u]
    if not trace or not flushes:
        return None
    secs, launches = kernel_seconds(trace, *DELTA_KERNELS)
    if not secs or launches != sum(u["launches"] for u in flushes) \
            or any(u["launches"] != rec["leaves"] for u in flushes):
        return None
    return 100.0 * len(flushes) * rec["delta_bound_s"] / secs


def device_idle(rec: Dict) -> Optional[float]:
    trace = rec.get("trace")
    if not trace or not trace["window_s"] or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def hbm_share(rec: Dict) -> Optional[float]:
    ms = untraced_mean_ms(rec, "compute_s")
    if ms is None:
        return None
    return 100.0 * rec["iter_bytes"] / counts.HBM_BYTES_PER_S / (ms * 1e-3)

