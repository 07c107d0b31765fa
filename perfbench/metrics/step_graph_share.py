"""Train steps replayed from CUDA graphs among all train steps (counters step.graph_replays / step.calls over the whole run: set-up's checked and warm-up steps, window, traced stretches), in %."""

from perfbench import program


def read(rec):
    share = program.ratio("step.graph_replays", "step.calls") if rec.kind == "train" else None
    return None if share is None else 100.0 * share
