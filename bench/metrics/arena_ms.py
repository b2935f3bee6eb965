"""Mean ms per flush in NVMArena.flush (ManagerStats.arena_seconds)."""

from bench.metrics._lib import untraced_mean_ms


def read(rec):
    return untraced_mean_ms(rec, "arena_s")
