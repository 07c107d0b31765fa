"""K1 launches over requests in the window: segment batches a request."""

from perfbench import readers


def read(rec):
    return rec.launches.get(readers.K1, 0) / rec.items if rec.kind == "generate" and rec.launches.get(readers.K1) else None
