"""The seeded traffic: the same seed gives the same requests and corpus
bytes, another seed other ones; every seed asks for the same lengths; the
corpus lies under the temporary directory alone."""

import hashlib
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

import perfbench_tiny as T
from perfbench.traffic import mix

LONG = {"rate": 16000, "lengths_s": [8.0, 32.0], "block": 64, "requests": 256,
        "pool": {"count": 4, "seconds": 40.0}}
CORPUS = {"corpus": {"files": 3, "seconds": 0.25, "rate": 48000}}
SEED = 2**31 + 12345  # past 32 signed bits


def requests_of(seed):
    waves = mix.pool(LONG, seed)
    return waves, mix.requests(LONG, seed, waves)


def test_one_seed_gives_the_same_requests_twice():
    (w1, r1), (w2, r2) = requests_of(SEED), requests_of(SEED)
    assert r1 == r2
    assert all(np.array_equal(a, b) for a, b in zip(w1, w2))


def test_another_seed_gives_other_requests_of_the_same_lengths():
    (_, r1), (w2, r2) = requests_of(SEED), requests_of(SEED + 1)
    assert [r.length for r in r1] != [r.length for r in r2]
    for i in range(0, LONG["requests"], LONG["block"]):
        block = slice(i, i + LONG["block"])
        assert sorted(r.length for r in r1[block]) == sorted(r.length for r in r2[block])
    lengths = np.array([r.length for r in r1]) / LONG["rate"]
    assert lengths.min() >= 8.0 and lengths.max() <= 32.0
    for r in r2:
        assert len(mix.audio_of(r, w2)) == r.length


def corpus_digest(tmp_path, seed, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    index = Path(mix.write_corpus(CORPUS, seed, threads=2))
    files = sorted(index.parent.glob("*.wav"))
    return index, hashlib.sha256(b"".join(f.read_bytes() for f in files)).hexdigest(), files


def test_corpus_bytes_repeat_for_a_seed_and_differ_for_another(tmp_path, monkeypatch):
    _, a, files = corpus_digest(tmp_path / "a", SEED, monkeypatch)
    _, b, _ = corpus_digest(tmp_path / "b", SEED, monkeypatch)
    _, c, _ = corpus_digest(tmp_path / "c", SEED + 1, monkeypatch)
    assert a == b != c
    assert len(files) == 3 and all(f.stat().st_size == 44 + 2 * 12000 for f in files)


def test_corpus_is_written_under_tmpdir_only(tmp_path, monkeypatch):
    before = set(os.listdir(T.REPO))
    index, _, files = corpus_digest(tmp_path, SEED, monkeypatch)
    assert all(Path(p).resolve().is_relative_to(tmp_path.resolve()) for p in (index, *files))
    assert set(os.listdir(T.REPO)) == before
    mix.remove_corpus(SEED)
    assert not index.parent.exists()


@pytest.mark.parametrize("seed", [1, SEED])
def test_device_segments_repeat(seed):
    m = {"batches": 2, "source_seconds": 1.0, "rate": 48000}
    a, b = mix.segment_batches(m, seed, 3, 992), mix.segment_batches(m, seed, 3, 992)
    assert a.shape == (2, 3, 992) and np.array_equal(a, b)
    assert not np.array_equal(a, mix.segment_batches(m, seed + 1, 3, 992))
