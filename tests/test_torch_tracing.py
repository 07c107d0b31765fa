"""The port's spans and counters (``mdctgan_tpu_torch/utils/tracing.py``) on
the CPU: off, a span is the shared null context and records nothing; on, a
request through ``api.upsample``, two train steps and an input pipeline
record their spans under one root a request or step, with the counters
that go with them; under ``torch.profiler`` every span is an annotation of
the same name, nested as in memory, with the recorder off; two threads keep
their own roots; counts add up from many threads and are kept with the
recorder off; and the serving program ``export_cli`` writes holds no
profiler node.

Sizes: the geometry of ``tests/test_torch_serve.py`` (n_fft 128, 8128-sample
segments, ``netG local`` ngf 4, one resblock and one attention block), a
2-scale discriminator of ndf 4 and 2 layers, batches of 2.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from mdctgan_tpu_torch import api, export_cli, serve_export
from mdctgan_tpu_torch.data import dataset as tds
from mdctgan_tpu_torch.data import native as tnative
from mdctgan_tpu_torch.data.pipeline import InputPipeline
from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform
from mdctgan_tpu_torch.ops.resample import resample
from mdctgan_tpu_torch.options import spectral_config_from_opt
from mdctgan_tpu_torch.train.schedule import make_optimizers
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_train_step
from mdctgan_tpu_torch.utils import tracing

SEG = 8128
SPECTRAL = dict(n_fft=128, hop_length=64, win_length=128, segment_length=SEG)
OPT = dict(
    SPECTRAL, bins=128, netG="local", ngf=4, n_downsample_global=2,
    n_blocks_global=1, n_blocks_local=1, n_blocks_attn_g=1, heads_g=2,
    dim_head_g=4, downsample_type="resconv", upsample_type="interpolate",
    ndf=4, n_layers_D=2, num_D=2, center=True, arcsinh_transform=True, abs_spectro=True,
    abs_norm=True, fit_residual=True, norm_range=[-1.0, 1.0], lr_sampling_rate=16000,
)
PARTS = ["k1", "g_forward", "d_forward", "backward", "optimizer"]
BATCH = 2


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and its store empty."""
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


@pytest.fixture(scope="module")
def model():
    return api.create_model(OPT, device="cpu")


def counted(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def within(outer, s):
    return outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


def children(spans, parent):
    """The spans directly inside ``parent``, in order: of its root, within
    it, and within no other such span."""
    inside = [s for s in spans if s.root == parent.root and s is not parent
              and within(parent, s)]
    return sorted((s for s in inside if not any(o is not s and within(o, s) for o in inside)),
                  key=lambda s: s.start_ns)


def roots(spans, name):
    """The spans named ``name``, each the outermost of its root."""
    out = [s for s in spans if s.name == name]
    assert len({r.root for r in out}) == len(out)
    for r in out:
        assert all(within(r, s) for s in spans if s.root == r.root)
    return out


def clip(seconds, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(int(16000 * seconds))).astype(
        np.float32)


def expected_padding(audio, batch_size):
    """The padding ``serve_segments`` adds to a request, counted from the
    segments ``AudioAppDataset`` cuts."""
    ds = tds.AudioAppDataset(audio, 16000, SEG)
    lr = resample(torch.from_numpy(ds.raw_audio)[None], 16000, 48000)[0].numpy()
    n = len(ds.segments_of(lr))
    return n, (-n) % batch_size


# ------------------------------------------------------------------- off
def test_off_a_span_is_the_shared_null_context_and_records_nothing(model):
    assert tracing.span("a") is tracing.span("b") is tracing._NULL
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    api.upsample(clip(0.2), 16000, model, is_lr_input=True, batch_size=BATCH)
    assert tracing.collect() == []


# ----------------------------------------------------------------- serving
def test_a_request_is_one_root_with_its_parts_and_counts(model):
    """Two requests: 5 segments (3 batches, one row of padding) and a clip
    shorter than a segment (one batch of one real row)."""
    requests = [clip(0.8, 1), clip(0.06, 2)]
    before = tracing.snapshot()
    tracing.enable()
    for audio in requests:
        api.upsample(audio, 16000, model, is_lr_input=True, batch_size=BATCH)
    tracing.disable()
    spans = tracing.collect()
    got = counted(before, tracing.snapshot())

    requested = roots(spans, "upsample")
    assert len(requested) == 2 and {s.root for s in spans} == {r.root for r in requested}
    segments, padded = zip(*(expected_padding(a, BATCH) for a in requests))
    assert segments == (5, 1)
    for root, n in zip(requested, segments):
        batches = -(-n // BATCH)
        # on the CPU there is no event to wait for: no serve.wait
        assert [s.name for s in children(spans, root)] == (
            ["upsample.lr", "upsample.to_host", "upsample.segment"]
            + ["serve.batch"] * batches + ["upsample.stitch"])
        assert len([s for s in spans if s.root == root.root]) == 5 + batches
    assert got["serve.rows"] == BATCH * sum(-(-n // BATCH) for n in segments) == 8
    assert got["serve.padded_rows"] == sum(padded) == 2


# ------------------------------------------------------------------- train
def test_a_train_step_is_one_root_with_its_five_parts_in_order():
    opt = OPT
    g_tx, d_tx = make_optimizers(2e-4, 0.5, 1, 1, 10)
    state = create_train_state(build_generator(opt), build_discriminator(opt), g_tx, d_tx,
                               device="cpu", rng=torch.Generator().manual_seed(0))
    step = build_train_step(SpectralTransform(spectral_config_from_opt(opt), "cpu"), g_tx,
                            d_tx, n_layers_d=2, num_d=2)
    x = torch.from_numpy(0.1 * np.random.default_rng(0).standard_normal((BATCH, SEG))).float()
    marks = []
    tracing.enable()
    for _ in range(2):
        state, _ = step(state, {"lr_audio": x, "hr_audio": x},
                        mark=lambda name: marks.append((name, time.perf_counter_ns())))
    tracing.disable()
    spans = tracing.collect()
    steps = roots(spans, "step")
    assert len(steps) == 2 and state.step == 2
    assert [name for name, _ in marks] == PARTS * 2
    for i, root in enumerate(steps):
        parts = children(spans, root)
        assert [s.name for s in parts] == [f"step.{p}" for p in PARTS]
        assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
        # mark(part) is called inside the part's span: one boundary a part
        for part, (_, t) in zip(parts, marks[i * len(PARTS):]):
            assert part.start_ns <= t <= part.end_ns
    assert len(spans) == 2 * (1 + len(PARTS))


# ----------------------------------------------------------------- pipeline
def _wait_full(pipe, size, timeout=60.0):
    t0 = time.monotonic()
    while pipe._queue.qsize() < size:
        assert time.monotonic() - t0 < timeout, "the worker never filled the queue"
        time.sleep(0.01)


def test_the_input_pipeline_counts_its_gets_and_depth(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(2):
        tnative.write_wav16(str(tmp_path / f"f{i}.wav"),
                            (0.3 * rng.standard_normal(SEG + 500)).astype(np.float32), 48000)
    ds = tds.AudioDataset(str(tmp_path), SEG, seed=0, serial=True)
    size, gets = 2, 3
    pipe = InputPipeline(ds, SpectralConfig(**SPECTRAL), BATCH, queue_size=size, device="cpu")
    try:
        before = tracing.snapshot()
        tracing.enable()
        for _ in range(gets):
            _wait_full(pipe, size)  # each get finds the queue full
            next(pipe)
        tracing.disable()
        got = counted(before, tracing.snapshot())
        for _ in range(gets):  # untraced: counted all the same
            next(pipe)
        more = counted(before, tracing.snapshot())
    finally:
        pipe.close()
    spans = tracing.collect()
    assert [s.name for s in spans] == ["pipeline.queue_wait", "pipeline.degrade"] * gets
    assert len({s.root for s in spans}) == len(spans)  # each its own root
    assert got["pipeline.gets"] == gets and got["pipeline.depth"] == gets * size
    assert more["pipeline.gets"] == 2 * gets
    assert gets * size <= more["pipeline.depth"] <= 2 * gets * size


# ----------------------------------------------------------------- profiler
def _annotations(prof):
    notes = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                   if getattr(e, "is_user_annotation", False))
    return [(a, -b, name) for a, b, name in notes]


def _nesting(intervals):
    """(name, the innermost enclosing interval's name or None) of each."""
    out = []
    for i, (a, b, name) in enumerate(intervals):
        parent = None
        for a2, b2, name2 in intervals[:i]:
            if a2 <= a and b <= b2:
                parent = name2  # the latest-starting one that covers it
        out.append((name, parent))
    return sorted(out, key=str)


def test_under_the_profiler_every_span_is_an_annotation_nested_as_in_memory(model):
    from torch.profiler import ProfilerActivity, profile

    audio = clip(0.8, 1)
    tracing.enable()
    api.upsample(audio, 16000, model, is_lr_input=True, batch_size=BATCH)
    tracing.disable()
    in_memory = _nesting(sorted(((s.start_ns, s.end_ns, s.name) for s in tracing.collect()),
                                key=lambda t: (t[0], -t[1])))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.upsample(audio, 16000, model, is_lr_input=True, batch_size=BATCH)
    assert tracing.collect() == []  # the recorder stayed off
    notes = _annotations(prof)
    assert _nesting(notes) == in_memory
    # outside a profiler no record_function is entered
    assert tracing.span("x") is tracing._NULL


# ------------------------------------------------------------------ threads
def test_two_threads_keep_their_own_roots():
    ready = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with tracing.span(f"{tag}.outer"):
                ready.wait()  # both outer spans are open at once
                with tracing.span(f"{tag}.inner"):
                    ready.wait()
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    tracing.enable()
    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    tracing.disable()
    assert not errors and not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in tracing.collect()}
    for tag in "ab":
        assert spans[f"{tag}.inner"].root == spans[f"{tag}.outer"].root
    assert spans["a.outer"].root != spans["b.outer"].root


def test_counts_from_many_threads_add_up():
    """More threads than cores, a short switch interval: no count is lost."""
    n_threads, per_thread = 16, 2000
    before = tracing.snapshot().get("test.stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tracing.count("test.stress")
                                                    for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tracing.snapshot()["test.stress"] - before == n_threads * per_thread


def test_counters_count_with_the_recorder_off_and_snapshot_is_a_copy():
    before = tracing.snapshot()
    tracing.count("test.off")
    tracing.count("test.off", 2)
    snap = tracing.snapshot()
    assert snap.get("test.off", 0) - before.get("test.off", 0) == 3
    snap["test.off"] = -1
    assert tracing.snapshot()["test.off"] != -1 and tracing.collect() == []


def test_a_span_left_by_an_exception_is_kept_and_closes_its_root():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError
    with tracing.span("next"):
        pass
    tracing.disable()
    spans = {s.name: s for s in tracing.collect()}
    assert spans["inner"].root == spans["outer"].root != spans["next"].root


# ------------------------------------------------------------------- export
def _profiler_nodes(program):
    return [n for n in program.graph.nodes if "profiler" in str(n.target)]


def test_the_exported_serving_program_holds_no_profiler_node(tmp_path, monkeypatch):
    """``export_cli`` run under a recording profiler with the recorder on:
    the serving chain enters no span while it is traced, and the program
    holds no profiler node.  A module with a span, exported the same way,
    records it: the check would see one."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(export_cli, "load_generator_state",
                        lambda opt, g: (g.state_dict(), []))
    flags = ["--gpu_ids", "-1", "--export_platforms", "cpu", "--export_batch", str(BATCH),
             "--export_path", str(tmp_path / "m.pt2"), "--load_pretrain", str(tmp_path),
             "--checkpoints_dir", str(tmp_path), "--jax_cache_dir", ""]
    for key in ("n_fft", "hop_length", "win_length", "segment_length", "bins", "ngf",
                "n_downsample_global", "n_blocks_global", "n_blocks_local",
                "n_blocks_attn_g", "heads_g", "dim_head_g", "lr_sampling_rate"):
        flags += [f"--{key}", str(OPT[key])]
    flags += ["--netG", "local", "--norm_range", "-1", "1", "--center", "--arcsinh_transform",
              "--abs_spectro", "--abs_norm", "--fit_residual"]

    class Spanned(torch.nn.Module):
        def forward(self, x):
            with tracing.span("inside"):
                return x * 2

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        out = export_cli.main(flags)
        entered = tracing.collect()
        control = torch.export.export(Spanned(), (torch.ones(2),), strict=False)
    tracing.disable()
    # export runs the forward's Python: a span there is recorded, and dropped
    # from the program
    assert entered == [] and [s.name for s in tracing.collect()] == ["inside"]
    assert not _profiler_nodes(control)
    program = torch.export.load(out["path"])
    assert not _profiler_nodes(program)
    x = torch.zeros((BATCH, SEG))
    assert serve_export.load(out["path"], device="cpu")(x).shape == (BATCH, SEG)


def test_queue_wait_spans_a_blocked_get(tmp_path):
    """An empty queue and a stopped worker: the get blocks inside
    ``pipeline.queue_wait`` until a batch arrives, and counts a depth of
    nothing."""
    rng = np.random.default_rng(4)
    tnative.write_wav16(str(tmp_path / "f.wav"),
                        (0.3 * rng.standard_normal(SEG + 10)).astype(np.float32), 48000)
    ds = tds.AudioDataset(str(tmp_path), SEG, seed=0, serial=True)
    pipe = InputPipeline(ds, SpectralConfig(**SPECTRAL), BATCH, queue_size=1, device="cpu")
    late = None
    try:
        _wait_full(pipe, 1)
        held = pipe._queue.get()
        pipe._stop.set()
        pipe._thread.join(timeout=10)
        assert not pipe._thread.is_alive()
        while not pipe._queue.empty():
            pipe._queue.get_nowait()
        pipe._stop.clear()
        late = threading.Timer(0.2, pipe._queue.put, args=(held,))
        before = tracing.snapshot()
        tracing.enable()
        late.start()
        next(pipe)
        tracing.disable()
        got = counted(before, tracing.snapshot())
    finally:
        if late is not None:
            late.join(timeout=10)
        pipe.close()
    wait = next(s for s in tracing.collect() if s.name == "pipeline.queue_wait")
    assert (wait.end_ns - wait.start_ns) / 1e9 >= 0.15
    assert got["pipeline.gets"] == 1 and got["pipeline.depth"] == 0  # found it empty
