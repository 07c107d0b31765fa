"""bf16 convolutions on the card whose input arrived channels-last, so that cuDNN relaid nothing, among all of them, in a generate run (counters conv.nhwc_in / conv.bf16_calls over the whole run: set-up, window, traced stretches; a CUDA graph's replay calls no Python and counts nothing), in %."""

from perfbench import program


def read(rec):
    share = program.ratio("conv.nhwc_in", "conv.bf16_calls") if rec.kind == "generate" else None
    return None if share is None else 100.0 * share
