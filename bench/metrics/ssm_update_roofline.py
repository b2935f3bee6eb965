"""ssm_update's byte bound over its device time in the traced decode steps
(%); the kernel's launches in the trace must equal the program's counter."""

from bench.trace import kernel_seconds

KERNEL = "ssm_update_kernel"


def read(rec):
    trace = rec.get("trace")
    steps = [u for u in rec.get("units", []) if u["traced"] and "ssm_launches" in u]
    if not trace or not steps:
        return None
    secs, launches = kernel_seconds(trace, KERNEL)
    counted = sum(u["ssm_launches"] for u in steps)
    if not secs or not counted or launches != counted:
        return None
    return 100.0 * counted * rec["ssm_bound_s"] / secs
