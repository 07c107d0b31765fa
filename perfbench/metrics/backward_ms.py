"""Device ms from the step's d_forward mark to its backward mark (CUDA events), mean a step."""

from perfbench import readers


def read(rec):
    return readers.mean_ms(rec, "backward")
