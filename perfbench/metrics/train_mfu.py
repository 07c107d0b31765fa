"""Model FLOPs of the window's train steps over its time, a share of the card's bf16 peak (%)."""

from perfbench import readers


def read(rec):
    return readers.mfu(rec, rec.items) if rec.kind == "train" else None
