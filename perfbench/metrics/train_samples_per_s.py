"""Samples of every step of the window over the window's wall time (a sync at its end)."""

from perfbench import stats


def read(rec):
    return stats.rate(rec.samples, rec.window_s) if rec.kind == "train" else None
