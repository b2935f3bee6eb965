"""delta_snapshot's byte bound over its device time in the traced flushes (%)."""

from bench.metrics._lib import delta_roofline


def read(rec):
    return delta_roofline(rec)
