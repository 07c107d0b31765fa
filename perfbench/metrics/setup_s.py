"""Set-up: process start to the first timed call (host clock)."""


def read(rec):
    return rec.setup_s
