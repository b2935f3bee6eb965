"""Set-up seconds: imports, the kernels' build, inputs from the seed, warm-up."""


def read(rec):
    return rec.get("setup_s")
