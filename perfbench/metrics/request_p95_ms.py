"""The 95th percentile (nearest rank) of every request's latency in the
window, from its call to the return of the host array: the serving loop's
tail, read in the traced run."""

from perfbench import readers


def read(rec):
    return readers.p95_ms(rec) if rec.kind == "generate" else None
