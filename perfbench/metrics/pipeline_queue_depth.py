"""Batches ready in the input pipeline's queue before each get (counters pipeline.depth / pipeline.gets over the whole run: set-up with the queue's first fill, window, traced stretches), where the run went through the pipeline."""

from perfbench import program


def read(rec):
    if rec.kind != "train" or not program.annotated(rec, "pipeline.queue_wait"):
        return None
    return program.ratio("pipeline.depth", "pipeline.gets")
