"""Host ms inside the train_step call, mean a step of the window."""

from perfbench import readers


def read(rec):
    return readers.mean_ms(rec, "train_step") if rec.kind == "train" else None
