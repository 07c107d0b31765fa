"""The port's FLAC encoder (``mdctgan_tpu_torch/data/flacenc.py``) against
the JAX package's (``mdctgan_tpu/data/flacenc.py``): the same bytes for the
same samples in every subframe kind, stereo mode, block size and a ragged
last block; lossless decodes through the port's ``data/native.py``; and
``compress_audio`` over a directory tree as the JAX package's.  Inputs are
made with numpy as ``tests/test_flac.py`` makes them."""

import filecmp
import os
import shutil

import numpy as np
import pytest

from mdctgan_tpu.data import flacenc as jflacenc

from mdctgan_tpu_torch.data import flacenc, native


def _pcm(rng, n, ch=None, scale=3000):
    shape = (n,) if ch is None else (n, ch)
    # correlated-ish signal so fixed predictors actually help
    x = np.cumsum(rng.standard_normal(shape), axis=0)
    return (scale * x / np.abs(x).max()).astype(np.int16)


# (samples, write_flac's keywords); 5000 samples leave a ragged last block
CASES = {
    **{f"mono_{force}": (lambda rng: _pcm(rng, 5000), {"force_subframe": force})
       for force in (None, "verbatim", "fixed0", "fixed1", "fixed2", "lpc2")},
    **{f"stereo_{mode}": (lambda rng: _pcm(rng, 5000, 2), {"stereo_mode": mode})
       for mode in ("independent", "left_side", "right_side", "mid_side")},
    "constant_blocks": (lambda rng: np.full(8192, -123, np.int16), {}),
    "stereo_constant": (lambda rng: np.full((4096, 2), 77, np.int16),
                        {"stereo_mode": "mid_side"}),
    "ragged_by_one": (lambda rng: _pcm(rng, 4097), {}),
    "block_1152": (lambda rng: _pcm(rng, 5000), {"block_size": 1152}),
    "block_1152_stereo": (lambda rng: _pcm(rng, 3000, 2),
                          {"block_size": 1152, "stereo_mode": "left_side"}),
}


@pytest.fixture
def native_lib():
    if native.load_library() is None:
        pytest.skip("native audioio library unavailable")


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_flac_writes_the_jax_bytes(tmp_path, rng, case):
    make, kw = CASES[case]
    pcm = make(rng)
    flacenc.write_flac(str(tmp_path / "port.flac"), pcm, 48000, **kw)
    jflacenc.write_flac(str(tmp_path / "jax.flac"), pcm, 48000, **kw)
    port, ref = (tmp_path / "port.flac").read_bytes(), (tmp_path / "jax.flac").read_bytes()
    assert len(port) > 42 and port == ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_reader_decodes_losslessly(tmp_path, rng, native_lib, case):
    make, kw = CASES[case]
    pcm = make(rng)
    path = str(tmp_path / "t.flac")
    flacenc.write_flac(path, pcm, 44100, **kw)
    data, rate = native.read(path)
    assert rate == 44100
    first = pcm if pcm.ndim == 1 else pcm[:, 0]
    np.testing.assert_array_equal(np.rint(np.asarray(data) * 32768.0).astype(np.int16), first)


def test_compress_audio_matches_jax(tmp_path, rng, native_lib):
    """A tree of WAVs (one nested, one in upper case, one that is not
    audio) converted by both: the same count and the same bytes of each
    FLAC, the WAVs kept."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    for rel, n in (("a.wav", 3000), ("sub/b.WAV", 5000), ("sub/c.wav", 1200)):
        x = np.cumsum(rng.standard_normal(n)) / 100.0
        native.write_wav16(str(src / rel), (0.5 * x / np.abs(x).max()).astype(np.float32), 16000)
    (src / "notes.txt").write_text("not audio")
    port, ref = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(src, port)
    shutil.copytree(src, ref)
    assert flacenc.compress_audio(str(port)) == jflacenc.compress_audio(str(ref)) == 3
    flacs = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, names in os.walk(port) for f in names if f.endswith(".flac"))
    assert flacs == ["a.flac", "sub/b.flac", "sub/c.flac"]
    match, mismatch, errors = filecmp.cmpfiles(port, ref, flacs, shallow=False)
    assert match == flacs and not mismatch and not errors
    assert (port / "a.wav").exists() and (port / "sub" / "b.WAV").exists()
    data, rate = native.read(str(port / "sub" / "c.flac"))
    assert rate == 16000 and len(data) == 1200
