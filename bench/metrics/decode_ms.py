"""Mean ms of one decode step of every session, waited for; flushes excluded."""

from bench.metrics._lib import untraced_mean_ms


def read(rec):
    return untraced_mean_ms(rec, "compute_s")
