"""The reader of the train step's graph counters (``step_graph_share``): on
synthetic records with fake counters, on a generate record, and for a port
without the counters."""

import json
import sys

import pytest

import perfbench_tiny as T
from perfbench import harness
from perfbench.harness import Record

from mdctgan_tpu_torch.utils import tracing


@pytest.fixture
def fresh_counters(monkeypatch):
    """The port's counters from zero, as in a run's own process."""
    monkeypatch.setattr(tracing, "COUNTERS", {})


def read(rec):
    path = T.REPO / "perfbench" / "metrics" / "step_graph_share.py"
    return harness.load_module(path, "step_graph_share").read(rec)


def test_declared_as_the_benchmark_reads_it():
    bench = json.loads((T.REPO / "BENCHMARK.json").read_text())
    m = bench["per_layer"][-1]
    assert m == {"name": "step_graph_share", "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "train step",
                 "moves": "train_samples_per_s", "workloads": ["train-b20-pipeline"]}


@pytest.mark.parametrize("calls, replays, share", [(200, 198, 99.0), (8, 0, 0.0), (4, 4, 100.0)])
def test_the_share_of_replayed_steps(fresh_counters, calls, replays, share):
    tracing.count("step.calls", calls)
    if replays:
        tracing.count("step.graph_replays", replays)
    tracing.count("step.graph_captures", 1)
    assert read(Record("train")) == pytest.approx(share)


def test_a_generate_record_reads_nothing(fresh_counters):
    tracing.count("step.calls", 3)
    tracing.count("step.graph_replays", 2)
    assert read(Record("generate")) is None


def test_a_port_without_the_counters_reads_nothing(fresh_counters, monkeypatch):
    # counters, but none of the step's
    tracing.count("pipeline.gets", 4)
    assert read(Record("train")) is None
    # no counters at all: the module is not there to import
    monkeypatch.setitem(sys.modules, "mdctgan_tpu_torch.utils.tracing", None)
    assert read(Record("train")) is None
