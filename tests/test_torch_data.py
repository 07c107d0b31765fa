"""The port's input side against the JAX package on the CPU: the random-crop
train dataset (the same files, offsets and rates from the same seed), the
native prefetcher, the degrade and the input pipeline, homogeneous and
mixed-rate, with its worker's errors and its refusal of a missing card.

Sizes: 8128-sample segments of WAVs at 48 and 24 kHz, batches of 2 to 4.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdctgan_tpu.data import dataset as jds
from mdctgan_tpu.data.pipeline import make_degrade_fn as j_make_degrade_fn
from mdctgan_tpu.ops.features import SpectralConfig as JSpectralConfig

from mdctgan_tpu_torch.data import dataset as tds
from mdctgan_tpu_torch.data import native as tnative
from mdctgan_tpu_torch.data.pipeline import InputPipeline, make_degrade_fn
from mdctgan_tpu_torch.ops.features import SpectralConfig

SEG = 8128
SPECTRAL = dict(n_fft=128, hop_length=64, win_length=128, segment_length=SEG)


def _corpus(root, lengths, rate=48000, seed=0, prefix="f"):
    """WAVs of random noise, one per length; returns their paths in order."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, n in enumerate(lengths):
        p = root / f"{prefix}{i}.wav"
        tnative.write_wav16(str(p), (0.3 * rng.standard_normal(n)).astype(np.float32), rate)
        paths.append(p)
    return paths


def _ramp_corpus(root, n_files, frames):
    """WAVs whose every sample says its file and position: sample n of file
    i is (i * frames + n) 16-bit steps above -1 (``_ramp_code``), so a
    decoded crop names both."""
    assert n_files * frames <= 65536
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        x = (i * frames + np.arange(frames) - 32768).astype(np.float32) / 32768.0
        tnative.write_wav16(str(root / f"r{i}.wav"), x, 48000)
    return root


def _ramp_code(row):
    return np.rint(row * 32768.0).astype(np.int64) + 32768


# --------------------------------------------------------------------------
# AudioDataset
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["random", "serial", "deterministic"])
def test_audio_dataset_matches_jax(tmp_path, mode):
    """The same files, offsets and rates, exactly, over 3 passes; files
    shorter than a segment are read from 0 and zero-padded."""
    _corpus(tmp_path / "c", [20000, 9000, 8128, 5000, 31000])
    kw = dict(serial=mode != "random", deterministic=mode == "deterministic")
    ours = tds.AudioDataset(str(tmp_path / "c"), SEG, seed=7, **kw)
    ref = jds.AudioDataset(str(tmp_path / "c"), SEG, seed=7, **kw)
    assert ours.files == ref.files and len(ours) == len(ref) == 5
    for _ in range(3):
        got, rates = ours.sample_batch_rates(5)
        want, ref_rates = ref.sample_batch_rates(5)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(rates, ref_rates)
    assert ours._cursor == ref._cursor
    assert ours._len_cache == ref._len_cache


def test_audio_dataset_skips_a_corrupt_file_as_jax_does(tmp_path):
    _corpus(tmp_path, [20000, 20000])
    (tmp_path / "f0b.wav").write_bytes(b"not a wav at all")  # sorts between f0 and f1
    ours = tds.AudioDataset(str(tmp_path), SEG, seed=1, serial=True)
    ref = jds.AudioDataset(str(tmp_path), SEG, seed=1, serial=True)
    for _ in range(6):
        got, want = ours.sample(), ref.sample()
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 48000
    (tmp_path / "f0.wav").write_bytes(b"junk")
    (tmp_path / "f1.wav").write_bytes(b"junk")
    with pytest.raises(RuntimeError, match="no decodable audio"):
        tds.AudioDataset(str(tmp_path), SEG, seed=1).sample()


# --------------------------------------------------------------------------
# the native prefetcher
# --------------------------------------------------------------------------

def test_native_prefetcher_rows_are_crops_of_corpus_files(tmp_path):
    if tnative.load_library() is None:
        pytest.skip("native library unavailable")
    frames, seg = 20000, 3000
    root = _ramp_corpus(tmp_path, 3, frames)
    files = [str(root / f"r{i}.wav") for i in range(3)]
    pf = tnative.NativePrefetcher(files, seg, n_threads=2, queue_cap=8, seed=3)
    try:
        seen = set()
        for _ in range(12):
            row, rate = pf.next()
            assert rate == 48000 and row.shape == (seg,)
            code = _ramp_code(row)
            i, off = divmod(int(code[0]), frames)
            np.testing.assert_array_equal(code, i * frames + off + np.arange(seg))
            assert off + seg <= frames
            seen.add(i)
        assert len(seen) > 1
    finally:
        pf.close()
    pf.close()  # a second close is a no-op
    pf.leak()


def test_ordered_prefetcher_reads_the_threads_streams_in_turn(tmp_path):
    """``OrderedPrefetcher``: the streams a prefetcher's threads are seeded
    with (``seed + i``), each on a thread of its own and read in turn, so
    two of them with one seed read the same segments."""
    if tnative.load_library() is None:
        pytest.skip("native library unavailable")
    frames, seg, n, rows = 20000, 3000, 3, 12
    root = _ramp_corpus(tmp_path, 3, frames)
    files = [str(root / f"r{i}.wav") for i in range(3)]
    ordered = [tnative.OrderedPrefetcher(files, seg, n_threads=n, queue_cap=5, seed=4)
               for _ in range(2)]
    streams = [tnative.NativePrefetcher(files, seg, n_threads=1, queue_cap=2, seed=4 + i)
               for i in range(n)]
    try:
        want = [streams[j % n].next() for j in range(rows)]
        for pf in ordered:
            for j in range(rows):
                row, rate = pf.next()
                np.testing.assert_array_equal(row, want[j][0])
                assert rate == want[j][1] == 48000
        assert len({int(_ramp_code(w[0])[0]) for w in want}) > 1
    finally:
        for pf in ordered + streams:
            pf.close()
    ordered[0].leak()  # after close, a no-op


def test_prefetcher_all_unreadable_raises_not_hangs(tmp_path):
    """A corpus where every file is undecodable surfaces as StopIteration
    from ``next()`` within bounded time (the port's copy of
    ``test_data.py::test_prefetcher_all_unreadable_raises_not_hangs``)."""
    bad1, bad2 = tmp_path / "a.wav", tmp_path / "b.wav"
    bad1.write_bytes(b"RIFF\x00\x00\x00\x00JUNK")
    bad2.write_bytes(b"garbage")
    if tnative.load_library() is None:
        pytest.skip("native library unavailable")
    pf = tnative.NativePrefetcher([str(bad1), str(bad2)], 1000, n_threads=2, queue_cap=4,
                                  seed=0)
    try:
        t0 = time.time()
        with pytest.raises(StopIteration):
            pf.next()
        assert time.time() - t0 < 30.0
    finally:
        pf.close()


# --------------------------------------------------------------------------
# the degrade and the pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [48000, 24000, 44100])
def test_make_degrade_fn_matches_jax(rng, rate):
    """HR and LR of the same segments within 1e-5 of their largest value
    (the resample's own bound against JAX, ``test_torch_serve.py``)."""
    x = (0.3 * rng.standard_normal((3, SEG))).astype(np.float32)
    ref = j_make_degrade_fn(JSpectralConfig(**SPECTRAL), rate, False, 55.0)(
        jnp.asarray(x), None)
    got = make_degrade_fn(SpectralConfig(**SPECTRAL), rate, False, 55.0)(
        torch.from_numpy(x), torch.Generator())
    for k in ("hr_audio", "lr_audio"):
        want = np.asarray(ref[k])
        assert got[k].shape == want.shape == (3, SEG)
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("mixed", [False, True])
def test_input_pipeline_matches_make_degrade_fn(tmp_path, mixed):
    """Serial batches through the pipeline on the CPU: each row equals the
    degrade of its own file's segment at its own rate (1e-6), which is
    within 1e-5 of its largest value of the JAX package's degrade, and both
    rates appear in a mixed batch."""
    files = _corpus(tmp_path, [SEG, SEG], 48000, seed=2, prefix="a")
    if mixed:
        files[1].unlink()
        _corpus(tmp_path, [SEG], 24000, seed=3, prefix="b")
    ds = tds.AudioDataset(str(tmp_path), SEG, seed=0, serial=True)
    cfg = SpectralConfig(**SPECTRAL)
    oracle = []
    for path in ds.files:
        seg, rate = tnative.read(path, 0, SEG)
        d = make_degrade_fn(cfg, rate, False, 55.0)(torch.from_numpy(seg)[None],
                                                     torch.Generator())
        oracle.append((rate, {k: v[0].numpy() for k, v in d.items()}))
        ref = j_make_degrade_fn(JSpectralConfig(**SPECTRAL), rate, False, 55.0)(
            jnp.asarray(seg)[None], None)
        for k, v in oracle[-1][1].items():
            want = np.asarray(ref[k][0])
            np.testing.assert_allclose(v, want, atol=1e-5 * np.abs(want).max(), err_msg=k)
    pipe = InputPipeline(ds, cfg, batch_size=4, device="cpu")
    try:
        for _ in range(3):
            batch = next(pipe)
            for i in range(4):
                rate, want = oracle[i % 2]
                for k in ("hr_audio", "lr_audio"):
                    assert batch[k].shape == (4, SEG) and batch[k].dtype == torch.float32
                    assert batch[k].is_contiguous()  # as the kernels on the card require
                    np.testing.assert_allclose(batch[k][i].numpy(), want[k], atol=1e-6)
        assert {r for r, _ in oracle} == ({48000, 24000} if mixed else {48000})
    finally:
        pipe.close()


def test_input_pipeline_random_crops_through_the_prefetcher(tmp_path):
    """Random sampling reads through the native prefetcher: at 48 kHz the HR
    row is the decoded crop itself, so each must be a crop of a file."""
    if tnative.load_library() is None:
        pytest.skip("native library unavailable")
    frames = 3 * SEG
    root = _ramp_corpus(tmp_path, 2, frames)
    ds = tds.AudioDataset(str(root), SEG, seed=4)
    pipe = InputPipeline(ds, SpectralConfig(**SPECTRAL), batch_size=3, device="cpu",
                         n_threads=2)
    try:
        assert pipe._prefetcher is not None
        for _ in range(2):
            hr = next(pipe)["hr_audio"].numpy()
            for row in hr:
                code = _ramp_code(row)
                i, off = divmod(int(code[0]), frames)
                np.testing.assert_array_equal(code, i * frames + off + np.arange(SEG))
    finally:
        pipe.close()
    assert pipe._prefetcher._handle is None  # destroyed once the worker had stopped


def test_input_pipeline_noise_is_seeded(tmp_path):
    """``add_noise``: the LR carries noise ~``snr`` dB under it, drawn from
    the pipeline's seeded generator (the same seed, the same batch); HR is
    untouched."""
    _corpus(tmp_path, [SEG], 48000, seed=5)
    cfg = SpectralConfig(**SPECTRAL)

    def first(seed, noise):
        ds = tds.AudioDataset(str(tmp_path), SEG, seed=0, serial=True)
        pipe = InputPipeline(ds, cfg, 2, add_noise=noise, snr=30.0, seed=seed, device="cpu")
        try:
            return next(pipe)
        finally:
            pipe.close()

    clean, a, b, c = first(1, False), first(1, True), first(1, True), first(2, True)
    assert torch.equal(a["lr_audio"], b["lr_audio"])
    assert not torch.equal(a["lr_audio"], c["lr_audio"])
    assert torch.equal(a["hr_audio"], clean["hr_audio"])
    noise = (a["lr_audio"] - clean["lr_audio"]).double()
    snr = 10 * torch.log10(clean["lr_audio"].double().square().sum(-1) / noise.square().sum(-1))
    assert torch.all((snr - 30.0).abs() < 0.5), snr


def test_input_pipeline_surfaces_worker_errors(tmp_path, monkeypatch):
    _corpus(tmp_path, [SEG], 48000)
    ds = tds.AudioDataset(str(tmp_path), SEG, seed=0, serial=True)

    def broken(batch_size):
        raise ValueError("decode exploded")

    monkeypatch.setattr(ds, "sample_batch_rates", broken)
    pipe = InputPipeline(ds, SpectralConfig(**SPECTRAL), 2, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="worker failed") as info:
            next(pipe)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        pipe.close()


def test_input_pipeline_probes_past_undecodable_files(tmp_path):
    (tmp_path / "a_bad.wav").write_bytes(b"junk")
    _corpus(tmp_path, [SEG], 24000)
    ds = tds.AudioDataset(str(tmp_path), SEG, seed=0, serial=True)
    pipe = InputPipeline(ds, SpectralConfig(**SPECTRAL), 2, device="cpu")
    try:
        assert pipe.orig_freq == 24000
    finally:
        pipe.close()
    (tmp_path / "f0.wav").write_bytes(b"junk")
    with pytest.raises(RuntimeError, match="no decodable audio files"):
        InputPipeline(tds.AudioDataset(str(tmp_path), SEG, serial=True),
                      SpectralConfig(**SPECTRAL), 2, device="cpu")


def test_input_pipeline_without_cuda_raises(tmp_path, monkeypatch):
    """The pipeline's device defaults to the card, never a silent CPU."""
    _corpus(tmp_path, [SEG], 48000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InputPipeline(tds.AudioDataset(str(tmp_path), SEG, serial=True),
                      SpectralConfig(**SPECTRAL), 2)
