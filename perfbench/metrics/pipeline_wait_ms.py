"""Host ms blocked in next(InputPipeline), mean a step of the window."""

from perfbench import readers


def read(rec):
    return readers.mean_ms(rec, "next_batch")
