"""Device ms from the step's k1 mark to its g_forward mark (CUDA events), mean a step."""

from perfbench import readers


def read(rec):
    return readers.mean_ms(rec, "g_forward")
