"""Share of the traced window in which no kernel, copy or fill ran on the device (%)."""

from bench.metrics._lib import device_idle


def read(rec):
    return device_idle(rec)
