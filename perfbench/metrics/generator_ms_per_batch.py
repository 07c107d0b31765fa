"""Device ms of every kernel in the trace but K1 and K2, over the segment batches in it."""

from perfbench import readers


def read(rec):
    return readers.generator_ms_per_batch(rec) if rec.kind == "generate" else None
