"""1 - device busy time over the traced stretch's wall time, generate cells (%)."""

from perfbench import readers


def read(rec):
    return readers.device_idle(rec) if rec.kind == "generate" else None
