"""Device ms of the Mamba-2 layers per traced decode step: the device time
of the work launched inside the program's ``model.mamba`` ranges (one
around each run of consecutive Mamba-2 layers) over the traced steps."""

RANGE = "model.mamba"


def read(rec):
    trace = rec.get("trace")
    row = (trace or {}).get("ranges", {}).get(RANGE)
    steps = sum(1 for u in rec.get("units", []) if u["traced"])
    if not row or not steps or not row["device_s"]:
        return None
    return 1e3 * row["device_s"] / steps
