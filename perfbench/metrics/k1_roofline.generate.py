"""K1's least time at the rows launched over its device time in the trace of the serving chain (%)."""

from perfbench import readers


def read(rec):
    return readers.roofline_share(rec, readers.K1) if rec.kind == "generate" else None
