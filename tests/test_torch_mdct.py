"""The port's transform kernels (plain versions on the CPU) against the JAX
reference: the Pallas kernels in interpret mode and the unfused
``SpectralTransform``.  The kernels themselves are tested on the card by
``tests/test_torch_cuda.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdctgan_tpu.ops import features as jfeat
from mdctgan_tpu.ops import window as jwindow
from mdctgan_tpu.ops.mdct import IMDCT as JIMDCT
from mdctgan_tpu.ops.mdct import MDCT as JMDCT
from mdctgan_tpu.ops.pallas_mdct import imdct_audio_fused, mdct_spectro_fused

from mdctgan_tpu_torch.ops import features as tfeat
from mdctgan_tpu_torch.ops import mdct as tmdct
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.ops import window as twindow

_LN10 = math.log(10.0)
GAIN, SCALE, SHIFT = 1000.0, 0.5, 0.25


def _cfg(n_fft, segment_length):
    return dict(n_fft=n_fft, hop_length=n_fft // 2, win_length=n_fft,
                segment_length=segment_length)


def test_kbd_window_matches_reference():
    for n in (128, 512):
        np.testing.assert_array_equal(twindow.kbd_window(n), jwindow.kbd_window(n))
    np.testing.assert_array_equal(
        twindow.kaiser_window(33, 4.0, periodic=True),
        jwindow.kaiser_window(33, 4.0, periodic=True))


@pytest.mark.parametrize("n_fft,t", [(128, 8128), (128, 8000), (512, 8128)])
def test_mdct_class_matches_reference(rng, n_fft, t):
    x = rng.standard_normal((2, t)).astype(np.float32)
    ref = np.asarray(JMDCT(n_fft)(jnp.asarray(x)))
    got = tmdct.MDCT(n_fft)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4)
    back = tmdct.IMDCT(n_fft)(torch.from_numpy(got)).numpy()
    ref_back = np.asarray(JIMDCT(n_fft)(jnp.asarray(ref)))
    np.testing.assert_allclose(back, ref_back, atol=1e-4)


@pytest.mark.parametrize("n_fft,t", [(128, 8128), (128, 8000), (512, 8128)])
def test_k1_plain_matches_pallas(rng, n_fft, t):
    x = rng.standard_normal((3, t)).astype(np.float32)
    ref = np.asarray(mdct_spectro_fused(
        jnp.asarray(x), n_fft, n_fft // 2, n_fft, gain=GAIN, scale=SCALE,
        shift=SHIFT, interpret=True))
    got = K.mdct_spectro(torch.from_numpy(x), K.spectro_matrix(n_fft),
                         GAIN, SCALE, SHIFT).numpy()
    assert got.shape == ref.shape == (3, K.n_frames_of(t, n_fft // 2), n_fft // 2)
    np.testing.assert_allclose(got, ref, atol=5e-4)


@pytest.mark.parametrize("n_fft,t", [(128, 8128), (128, 8000)])
def test_k1_plain_raw_mode_matches_pallas(rng, n_fft, t):
    x = rng.standard_normal((2, t)).astype(np.float32)
    ref = np.asarray(mdct_spectro_fused(
        jnp.asarray(x), n_fft, n_fft // 2, n_fft, gain=0.0, interpret=True))
    got = K.mdct_spectro(torch.from_numpy(x), K.spectro_matrix(n_fft)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("n_fft,t", [(128, 8128), (128, 8000), (512, 32512)])
def test_to_spectro_matches_unfused_reference(rng, n_fft, t):
    cfg = _cfg(n_fft, t)
    x = (0.1 * rng.standard_normal((2, t))).astype(np.float32)
    jt = jfeat.SpectralTransform(jfeat.SpectralConfig(**cfg), use_fused=False)
    ref, _, ref_np = jt.to_spectro(jnp.asarray(x))
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**cfg))
    got, got_np = tt.to_spectro(torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert got_np == {"min": float(ref_np["min"].item()), "max": float(ref_np["max"].item())}


def test_normalize_denormalize_match_reference(rng):
    cfg = _cfg(128, 8128)
    spec = (0.05 * rng.standard_normal((2, 1, 16, 64))).astype(np.float32)
    jt = jfeat.SpectralTransform(jfeat.SpectralConfig(**cfg), use_fused=False)
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**cfg))
    ref, ref_np = jt.normalize(jnp.asarray(spec))
    got, got_np = tt.normalize(torch.from_numpy(spec))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    y = rng.uniform(-1, 1, spec.shape).astype(np.float32)
    ref_d = jt.denormalize(jnp.asarray(y), ref_np["min"], ref_np["max"])
    got_d = tt.denormalize(torch.from_numpy(y), got_np["min"], got_np["max"])
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tt.g_input(torch.from_numpy(y)).numpy(), np.asarray(jt.g_input(jnp.asarray(y))))


def test_geometry_and_config_rejections():
    with pytest.raises(NotImplementedError):
        K.check_geometry(512, 128, 512)
    with pytest.raises(NotImplementedError):
        tfeat.SpectralTransform(tfeat.SpectralConfig(hop_length=128))
    for bad in (dict(raw_mdct=True), dict(explicit_encoding=True),
                dict(arcsinh_transform=False), dict(abs_norm=False),
                dict(mask=True)):
        with pytest.raises(NotImplementedError):
            tfeat.SpectralTransform(tfeat.SpectralConfig(**bad))


@pytest.mark.parametrize("n_fft,frames", [(128, 128), (512, 128)])
def test_k2_plain_matches_pallas_and_unfused(rng, n_fft, frames):
    # inputs span the real normalised range; the denormalisation slope is
    # steep near |y| = 1, so the bound is 1e-3 absolute as in the reference
    y = rng.uniform(-1.0, 1.0, (2, frames, n_fft // 2)).astype(np.float32)
    scale, shift = 5.0, 0.0
    ref_fused = np.asarray(imdct_audio_fused(
        jnp.asarray(y), n_fft, n_fft // 2, n_fft, gain=GAIN, scale=scale,
        shift=shift, interpret=True))
    got = K.imdct_audio(torch.from_numpy(y), K.synth_matrix(n_fft), GAIN,
                        scale, shift).numpy()
    assert got.shape == ref_fused.shape == (2, (frames - 1) * n_fft // 2)
    np.testing.assert_allclose(got, ref_fused, atol=1e-3)

    cfg = _cfg(n_fft, (frames - 1) * n_fft // 2)
    jt = jfeat.SpectralTransform(jfeat.SpectralConfig(**cfg), use_fused=False)
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**cfg))
    lo, hi = tt.cfg.src_range
    ref_np = {"min": jnp.full((1, 1, 1, 1), lo), "max": jnp.full((1, 1, 1, 1), hi)}
    ref = np.asarray(jt.to_audio(jnp.asarray(y[:, None]), ref_np))
    got2 = tt.to_audio(torch.from_numpy(y[:, None]), tt.norm_param()).numpy()
    np.testing.assert_allclose(got2, ref, atol=1e-3)


def test_k2_plain_raw_mode_matches_pallas(rng):
    spec = rng.standard_normal((1, 40, 256)).astype(np.float32)
    ref = np.asarray(imdct_audio_fused(jnp.asarray(spec), gain=0.0, interpret=True))
    got = K.imdct_audio(torch.from_numpy(spec), K.synth_matrix(512)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("n_fft", [128, 512])
def test_k1_k2_roundtrip(rng, n_fft):
    x = (0.1 * rng.standard_normal((2, 32512))).astype(np.float32)
    y = K.mdct_spectro(torch.from_numpy(x), K.spectro_matrix(n_fft), GAIN, 0.1, 0.0)
    back = K.imdct_audio(y, K.synth_matrix(n_fft), GAIN, 10.0, 0.0).numpy()
    assert back.shape == x.shape
    np.testing.assert_allclose(back, x, atol=1e-4)


def test_plain_versions_run_in_float64(rng):
    x = rng.standard_normal((1, 4096))
    x32 = torch.from_numpy(x.astype(np.float32))
    y64 = K.mdct_spectro(torch.from_numpy(x), K.spectro_matrix(128, dtype=torch.float64), GAIN)
    y32 = K.mdct_spectro(x32, K.spectro_matrix(128), GAIN)
    assert y64.dtype == torch.float64
    # asinh(1000 x)/ln10 has slope ~434 at 0: K1's normalized bound of 5e-4
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), atol=5e-4)
