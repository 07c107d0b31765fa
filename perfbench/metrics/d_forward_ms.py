"""Device ms from the step's g_forward mark to its d_forward mark (CUDA events), mean a step."""

from perfbench import readers


def read(rec):
    return readers.mean_ms(rec, "d_forward")
