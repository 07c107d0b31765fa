"""Seconds of 48 kHz output of every request of the window over its wall time."""

from perfbench import stats


def read(rec):
    return stats.rate(rec.audio_out_s, rec.window_s) if rec.kind == "generate" else None
