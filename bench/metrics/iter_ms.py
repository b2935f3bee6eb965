"""Window seconds over solver iterations completed, with the flushes the
cell makes (ms)."""


def read(rec):
    return 1e3 * rec["window_s"] / len(rec["units"]) if rec.get("units") else None
