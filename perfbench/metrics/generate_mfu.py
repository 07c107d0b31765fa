"""Generator FLOPs of every real (unpadded) segment of the window over its time, a share of the card's bf16 peak (%)."""

from perfbench import readers


def read(rec):
    return readers.mfu(rec, rec.segments) if rec.kind == "generate" else None
