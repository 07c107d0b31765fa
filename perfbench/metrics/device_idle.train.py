"""1 - device busy time (the union of the device records) over the traced stretch's wall time, train cells (%)."""

from perfbench import readers


def read(rec):
    return readers.device_idle(rec) if rec.kind == "train" else None
