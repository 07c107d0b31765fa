"""The readers of the bf16 convolutions' layout counters
(``nhwc_conv_share.train``, ``nhwc_conv_share.generate``): on synthetic
records with fake counters, on a record of the other kind, for a port
without the counters, and their declarations, picked by name."""

import json
import sys

import pytest

import perfbench_tiny as T
from perfbench import harness
from perfbench.harness import Record

from mdctgan_tpu_torch.utils import tracing

KINDS = ("train", "generate")


@pytest.fixture
def fresh_counters(monkeypatch):
    """The port's counters from zero, as in a run's own process."""
    monkeypatch.setattr(tracing, "COUNTERS", {})


def read(kind, rec):
    name = f"nhwc_conv_share.{kind}"
    return harness.load_module(T.REPO / "perfbench" / "metrics" / f"{name}.py", name).read(rec)


@pytest.mark.parametrize("kind, moves, workloads", [
    ("train", "train_samples_per_s", ["train-b20-pipeline"]),
    ("generate", "generate_audio_s_per_s", ["generate-long", "generate-clips"]),
])
def test_declared_as_the_benchmark_reads_it(kind, moves, workloads):
    bench = json.loads((T.REPO / "BENCHMARK.json").read_text())
    m = next(m for m in bench["per_layer"] if m["name"] == f"nhwc_conv_share.{kind}")
    assert m == {"name": f"nhwc_conv_share.{kind}", "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "generator", "moves": moves,
                 "workloads": workloads}
    # every cell it lists reports the metric it moves; the float32 cell is not listed
    e2e = next(e for e in bench["end_to_end"] if e["name"] == moves)
    assert set(workloads) <= set(e2e["workloads"]) and "generate-long-f32" not in workloads


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("calls, nhwc, share", [(400, 400, 100.0), (400, 380, 95.0),
                                                (8, 0, 0.0)])
def test_the_share_of_convolutions_given_nhwc(fresh_counters, kind, calls, nhwc, share):
    tracing.count("conv.bf16_calls", calls)
    if nhwc:
        tracing.count("conv.nhwc_in", nhwc)
    assert read(kind, Record(kind)) == pytest.approx(share)


@pytest.mark.parametrize("kind", KINDS)
def test_a_record_of_the_other_kind_reads_nothing(fresh_counters, kind):
    tracing.count("conv.bf16_calls", 3)
    tracing.count("conv.nhwc_in", 3)
    other = next(k for k in KINDS if k != kind)
    assert read(kind, Record(other)) is None


@pytest.mark.parametrize("kind", KINDS)
def test_a_port_without_the_counters_reads_nothing(fresh_counters, monkeypatch, kind):
    # counters, but no bf16 convolution (the float32 cell, or the port before them)
    tracing.count("serve.rows", 16)
    assert read(kind, Record(kind)) is None
    # no counters at all: the module is not there to import
    monkeypatch.setitem(sys.modules, "mdctgan_tpu_torch.utils.tracing", None)
    assert read(kind, Record(kind)) is None
