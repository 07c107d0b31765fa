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


@pytest.mark.parametrize("n_fft,t", [(128, 8128), (128, 8000), (512, 8128), (96, 4800)])
def test_k1_plain_matches_pallas(rng, n_fft, t):
    x = rng.standard_normal((3, t)).astype(np.float32)
    ref = np.asarray(mdct_spectro_fused(
        jnp.asarray(x), n_fft, n_fft // 2, n_fft, gain=GAIN, scale=SCALE,
        shift=SHIFT, interpret=True))
    got = K.mdct_spectro(torch.from_numpy(x), K.spectro_matrix(n_fft),
                         GAIN, SCALE, SHIFT).numpy()
    assert got.shape == ref.shape == (3, K.n_frames(t, n_fft, n_fft // 2), n_fft // 2)
    np.testing.assert_allclose(got, ref, atol=5e-4)


def test_k1_plain_matches_pallas_at_n480(rng):
    """K1 at n_fft 480 (hop 240: a 10 ms hop at 24 kHz; the card's dense
    form) against the Pallas kernel in interpret mode at K1's 5e-4, on
    noise at sigma 0.25 (audio within [-1, 1], as the normalized mode's
    input is).  On unit-variance noise the two float32 versions part by up
    to 7.2e-4 at the arcsinh's slope of ~217 near 0, where float32 itself
    is out of reach of 5e-4: on one draw the Pallas kernel read 5.0e-4 from
    float64 and the port 2.7e-4, on another the port 8.0e-4."""
    n_fft, t = 480, 9600
    mat = K.spectro_matrix(n_fft)
    x = (0.25 * rng.standard_normal((3, t))).astype(np.float32)
    ref = np.asarray(mdct_spectro_fused(
        jnp.asarray(x), n_fft, n_fft // 2, n_fft, gain=GAIN, scale=SCALE,
        shift=SHIFT, interpret=True))
    got = K.mdct_spectro(torch.from_numpy(x), mat, GAIN, SCALE, SHIFT).numpy()
    assert got.shape == ref.shape == (3, K.n_frames(t, n_fft, n_fft // 2), n_fft // 2)
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
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**cfg), "cpu")
    got, _, got_np = tt.to_spectro(torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert got_np == {"min": float(ref_np["min"].item()), "max": float(ref_np["max"].item())}


def test_normalize_denormalize_match_reference(rng):
    cfg = _cfg(128, 8128)
    spec = (0.05 * rng.standard_normal((2, 1, 16, 64))).astype(np.float32)
    jt = jfeat.SpectralTransform(jfeat.SpectralConfig(**cfg), use_fused=False)
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**cfg), "cpu")
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
    """K1/K2 still refuse every framing but hop = win/2 = N, the transform's
    kernels included; the configurations the transform refused before build
    now, on the matmul form where the JAX package runs its XLA path
    (a masked flagship config stays on K1).  Their parity with JAX is in
    ``tests/test_torch_spectral_modes.py``."""
    with pytest.raises(NotImplementedError):
        K.check_geometry(512, 128, 512)
    with pytest.raises(NotImplementedError):
        K.mdct_spectro(torch.zeros(1, 1024), K.spectro_matrix(512), hop_length=128)
    t = tfeat.SpectralTransform(tfeat.SpectralConfig(hop_length=128), "cpu")
    assert not t.fused
    for bad, fused in ((dict(raw_mdct=True), False), (dict(explicit_encoding=True), False),
                       (dict(arcsinh_transform=False), False), (dict(abs_norm=False), False),
                       (dict(mask=True), True), (dict(center=False), False)):
        assert tfeat.SpectralTransform(tfeat.SpectralConfig(**bad), "cpu").fused == fused


@pytest.mark.parametrize("n_fft,frames", [(128, 128), (512, 128), (96, 100), (480, 40)])
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
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**cfg), "cpu")
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


# --------------------------------------------------------------------------
# the FFT form of K1/K2, step by step in float64 on the CPU
# --------------------------------------------------------------------------

def _table_sections(tab, n):
    """The sections of ``fft_tables(n)`` in the kernels' layout."""
    q = n // 4
    window, rest = tab[:n], tab[n:]
    pairs = torch.complex(rest[0::2], rest[1::2])
    pre, roots, post, post_inv = torch.split(pairs, [q, q // 2, q, q])
    return window, pre, roots, post, post_inv


def _fft_dif(z, roots):
    """The kernels' radix-2 decimation in frequency: natural-order input;
    stage ``len`` maps the pair (p, p + len/2) of each block to (a + b,
    (a - b) roots[(p mod len/2) << shift]); the output lies at bit-reversed
    positions, returned here in natural order."""
    q = z.shape[-1]
    bits = q.bit_length() - 1
    x = z.clone()
    p = torch.arange(q)
    length, shift = q, 0
    while length >= 2:
        half = length // 2
        top = p[(p % length) < half]
        a, b = x[..., top], x[..., top + half]
        x[..., top] = a + b
        x[..., top + half] = (a - b) * roots[(top % half) << shift]
        length, shift = half, shift + 1
    rev = torch.tensor([int(format(m, f"0{bits}b")[::-1], 2) for m in range(q)])
    return x[..., rev]


def _dct4(v_at, m_pts, pre, roots, post):
    """pre-twiddle of (v[2m], v[M-1-2m]), FFT, post-twiddle, unpack."""
    m = torch.arange(m_pts // 2)
    z = torch.complex(v_at(2 * m), v_at(m_pts - 1 - 2 * m)) * pre
    w = _fft_dif(z, roots) * post
    out = torch.empty(*w.shape[:-1], m_pts, dtype=w.real.dtype)
    out[..., 2 * m], out[..., m_pts - 1 - 2 * m] = w.real, -w.imag
    return out


@pytest.mark.parametrize("n_fft", [64, 128, 512, 2048])
def test_fft_form_reproduces_dense_transform(rng, n_fft):
    m_pts, q = n_fft // 2, n_fft // 4
    tab = tmdct.fft_tables(n_fft, dtype=torch.float64)
    assert tab.numel() == 11 * n_fft // 4
    window, pre, roots, post, post_inv = _table_sections(tab, n_fft)
    np.testing.assert_array_equal(window.numpy(), twindow.kbd_window(n_fft))

    # forward: window, fold, DCT-IV, as K1 indexes them
    sig = torch.from_numpy(rng.standard_normal((2, 4 * n_fft + 40)))
    frames = tmdct.frame_signal(sig, n_fft, m_pts) * window
    x = lambda i: frames[..., i]  # noqa: E731

    def fold(j):
        return torch.where(j < q, -x((3 * q - 1 - j) % n_fft) - x((3 * q + j) % n_fft),
                           x((j - q) % n_fft) - x((3 * q - 1 - j) % n_fft))

    got = _dct4(fold, m_pts, pre, roots, post)
    ref = tmdct.mdct(sig, tmdct.spectro_matrix(n_fft, dtype=torch.float64))
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-9 * float(ref.abs().max())

    # inverse: DCT-IV with 4/N folded in, unfold, window, overlap-add, as
    # K2's output loop reads u
    spec = torch.from_numpy(rng.standard_normal((2, 24, m_pts)))
    u = _dct4(lambda j: spec[..., j], m_pts, pre, roots, post_inv)
    n = torch.arange(m_pts)
    u0, u1 = u[..., :-1, :], u[..., 1:, :]
    h1 = torch.where(n < q, -u0[..., (q - 1 - n) % m_pts], -u0[..., (n - q) % m_pts])
    h0 = torch.where(n < q, u1[..., (q + n) % m_pts], -u1[..., (3 * q - 1 - n) % m_pts])
    got_audio = (h1 * window[m_pts:] + h0 * window[:m_pts]).reshape(2, -1)
    ref_audio = tmdct.imdct(spec, tmdct.synth_matrix(n_fft, dtype=torch.float64))
    assert got_audio.shape == ref_audio.shape
    assert (float((got_audio - ref_audio).abs().max())
            <= 1e-9 * float(ref_audio.abs().max()))


def test_kernel_choice_by_n_fft():
    powers = {64, 128, 256, 512, 1024, 2048}
    for n_fft in range(8, 4104, 8):
        for kernel in ("mdct_spectro", "imdct_audio"):
            name = K.kernel_for(kernel, n_fft)
            assert name == (kernel if n_fft in powers else f"{kernel}_dense")
            assert name in K.LAUNCHES
    assert K.kernel_for("mdct_spectro", 480) == "mdct_spectro_dense"
    assert K.kernel_for("imdct_audio", 4096) == "imdct_audio_dense"
    assert K.kernel_for("imdct_audio", 512) == "imdct_audio"


def test_kernel_asinh_sinh_formulas_in_float32():
    """K1's asinh as ``sign(u) log(|u| + sqrt(u^2 + 1))`` and K2's sinh as
    ``(e - 1/e)/2`` with one exp (``AsinhAffine`` in csrc/mdct_spectro.cu,
    ``AffineSinh`` in csrc/imdct_audio.cu), in float32 against float64 over
    the range the kernels see (gain 1000; K2's input (5y)*ln10, |y| <= 1)."""
    y = np.concatenate([np.logspace(-12, 3, 20001), -np.logspace(-12, 3, 2001)])
    y = y.astype(np.float32)
    a = np.abs(np.float32(1000) * y)
    got = np.copysign(np.log(a + np.sqrt(a * a + np.float32(1))), y)
    assert got.dtype == np.float32
    assert np.abs(got - np.arcsinh(1000 * y.astype(np.float64))).max() <= 1e-6
    t = np.linspace(-11.6, 11.6, 20001).astype(np.float32)
    e = np.exp(t)
    got = (e - np.float32(1) / e) * np.float32(0.5 / 1000)
    assert got.dtype == np.float32
    ref = np.sinh(t.astype(np.float64)) / 1000
    assert (np.abs(got - ref) <= 5e-7 * np.abs(ref) + 5e-10).all()
