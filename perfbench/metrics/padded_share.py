"""Rows of zero padding among the segment rows sent to the generator (counters serve.padded_rows / serve.rows over the whole run: warm-up requests, window, traced stretches), in %."""

from perfbench import program


def read(rec):
    share = program.ratio("serve.padded_rows", "serve.rows") if rec.kind == "generate" else None
    return None if share is None else 100.0 * share
