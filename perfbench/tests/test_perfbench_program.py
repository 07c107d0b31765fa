"""The readers of the port's own counters (``perfbench/program.py`` and its
two metrics): on a synthetic record, in traced CPU runs of the tiny cells,
against the work the traffic file asks for, and in runs of a port without
them (the parent commit's), whose result line keeps every other metric and
leaves these out."""

import contextlib
import json
import math
import sys

import pytest

import perfbench_tiny as T
from perfbench import harness
from perfbench.harness import Record
from perfbench.trace import Record as Span
from perfbench.trace import Trace
from perfbench.traffic import mix as traffic

from mdctgan_tpu_torch.utils import tracing

TRAIN_METRICS = {"pipeline_queue_depth"}
GENERATE_METRICS = {"padded_share"}
NEW = TRAIN_METRICS | GENERATE_METRICS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return T.make_root(tmp_path_factory.mktemp("perfbench_program"))


@pytest.fixture
def fresh_counters(monkeypatch):
    """The port's counters from zero, as in a run's own process."""
    monkeypatch.setattr(tracing, "COUNTERS", {})


def read(name, rec):
    return harness.load_module(T.REPO / "perfbench" / "metrics" / f"{name}.py", name).read(rec)


def test_the_new_metrics_are_declared_as_the_benchmark_reads_them():
    bench = json.loads((T.REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(declared) == NEW
    assert [m["name"] for m in bench["per_layer"][-len(NEW):]] == list(declared)
    for name, m in declared.items():
        want = ["train-b20-pipeline"] if name in TRAIN_METRICS else ["generate-long",
                                                                     "generate-clips"]
        assert m["workloads"] == want and m["source"] == "program_counter"


# ------------------------------------------------------ a synthetic record
def labelled(notes):
    tr = Trace([Span(0, 1, "k")], [], [], 1e-3)
    tr.labelled = Trace([Span(0, 1, "k")], [], notes, 1e-3)
    return tr


def record(kind, notes):
    rec = Record(kind)
    rec.trace = labelled(notes)
    return rec


def test_the_readers_on_a_synthetic_record(fresh_counters):
    train = record("train", [Span(0, 300, "next_batch"), Span(0, 200, "pipeline.queue_wait")])
    gen = record("generate", [Span(0, 5_000, "request"), Span(0, 5_000, "upsample")])
    device_fed = record("train", [Span(0, 300, "next_batch")])
    for name, counts in (("pipeline.gets", 4), ("pipeline.depth", 10), ("serve.rows", 64),
                         ("serve.padded_rows", 40)):
        tracing.count(name, counts)
    assert read("pipeline_queue_depth", train) == pytest.approx(2.5)
    assert read("padded_share", gen) == pytest.approx(62.5)
    # a train run that never went through the pipeline reads no depth
    assert read("pipeline_queue_depth", device_fed) is None
    assert read("pipeline_queue_depth", gen) is None and read("padded_share", train) is None


def test_nothing_to_read_gives_none(fresh_counters):
    """No trace, a trace without the port's spans, no counter."""
    for kind in ("train", "generate"):
        bare = Record(kind)
        old = record(kind, [Span(0, 10, "train_step"), Span(0, 10, "request")])
        spanned = record(kind, [Span(0, 10, "pipeline.queue_wait")])
        for rec in (bare, old, spanned):
            assert all(read(name, rec) is None for name in NEW)


# ---------------------------------------------------------- traced CPU runs
def without_the_ports_tracing(monkeypatch):
    """The port as it was before its spans and counters: no span on the
    profiler's timeline, no counter, and no module to import."""
    monkeypatch.setattr(tracing, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "count", lambda name, n=1: None)
    monkeypatch.setitem(sys.modules, "mdctgan_tpu_torch.utils.tracing", None)


@pytest.mark.parametrize("cell", ["tiny-train-pipeline", "tiny-generate"])
def test_a_port_without_spans_leaves_the_new_metrics_out(root, monkeypatch, fresh_counters, cell):
    rc, line = T.run(root, cell, seed=2**33 + 5, trace=1)
    assert rc == 0 and line["correct"] is True
    mine = TRAIN_METRICS if "train" in cell else GENERATE_METRICS
    assert set(line["metrics"]) >= mine

    without_the_ports_tracing(monkeypatch)
    rc, old = T.run(root, cell, seed=2**33 + 5, trace=1)
    assert rc == 0 and old["correct"] is True
    assert list(old) == list(line)
    assert set(old["metrics"]) == set(line["metrics"]) - NEW


def test_padded_share_is_the_padding_the_traffic_asks_for(root, fresh_counters):
    """The generate cell's counters against the requests it served (set-up's
    warm-up, the window, the traced stretch), cut into segments and batches
    from their lengths alone."""
    mix, opt = T.MIXES["tiny-requests"], T.GENERATE
    seed = 2**32 + 9
    rc, line = T.run(root, "tiny-generate", seed=seed, trace=1)
    assert rc == 0 and line["correct"] is True
    requests = traffic.requests(mix, seed, traffic.pool(mix, seed))
    served = (requests[-mix["warmup_requests"]:] + requests[:line["attempted"]
              + mix["trace_requests"] + mix["label_requests"]])
    seg, batch = opt["segment_length"], opt["batchSize"]
    up = opt["hr_sampling_rate"] // mix["rate"]
    segments = [max(1, math.ceil(r.length * up / seg)) for r in served]
    rows = sum(-(-n // batch) * batch for n in segments)
    padded = rows - sum(segments)
    c = tracing.snapshot()
    assert (c["serve.rows"], c["serve.padded_rows"]) == (rows, padded)
    assert line["metrics"]["padded_share"]["value"] == pytest.approx(100.0 * padded / rows)


def test_traced_train_run_reads_the_queue_depth(root, fresh_counters):
    rc, line = T.run(root, "tiny-train-pipeline", seed=2**31 + 7, trace=1)
    assert rc == 0 and line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(m) >= TRAIN_METRICS
    c = tracing.snapshot()
    assert m["pipeline_queue_depth"] == pytest.approx(c["pipeline.depth"] / c["pipeline.gets"])
    assert 0 <= m["pipeline_queue_depth"] <= T.MIXES["tiny-corpus"]["queue_size"]
