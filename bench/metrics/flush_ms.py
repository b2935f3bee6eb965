"""Mean host ms of one synchronous maybe_flush."""

from bench.metrics._lib import untraced_mean_ms


def read(rec):
    return untraced_mean_ms(rec, "flush_s")
