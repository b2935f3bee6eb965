"""The whole iteration's share of the HBM bound: frozen bytes per iteration
at 3.35 TB/s over solver_ms (%)."""

from bench.metrics._lib import hbm_share


def read(rec):
    return hbm_share(rec)
