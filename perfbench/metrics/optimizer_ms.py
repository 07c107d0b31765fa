"""Device ms from the step's backward mark to its optimizer mark (CUDA events), mean a step."""

from perfbench import readers


def read(rec):
    return readers.mean_ms(rec, "optimizer")
