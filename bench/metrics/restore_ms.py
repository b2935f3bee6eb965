"""Mean host ms of one restore after the window: a new manager restores into
fresh device buffers, then one resumed step."""


def read(rec):
    r = rec.get("restore_s")
    return 1e3 * sum(r) / len(r) if r else None
