"""The decode step's share of its roofline (%): the least time its
operations and bytes need on the card (``bound_s``, from the
configuration's counts at the step's attended length) over the step's
measured time, summed over the untraced steps."""


def read(rec):
    units = [u for u in rec.get("units", []) if "bound_s" in u and not u["traced"]]
    if not units:
        return None
    return 100.0 * sum(u["bound_s"] for u in units) / sum(u["compute_s"] for u in units)
