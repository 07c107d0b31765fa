"""Every spectral mode, framing and mask of the port's ``SpectralTransform``
against the JAX package's, on the CPU at small geometry, from numpy seeds.

The matmul form's spectrum is held to the JAX spectrum at 1e-5 of its
largest value.  The normalizations are then held on the *same* spectrum: the
JAX transform's ``mdct`` is patched (in the test, on one instance) to return
the port's.  The dB modes take ``log10`` of each bin's magnitude and, per
sample, its minimum: a bin near zero turns the float32 rounding of two
matmuls that sum in different orders into a shift of every normalized value
of its sample, which says nothing about the port.  The arcsinh and raw modes
are held end to end as well.  The random paths (the mask's noise fill, the
dB pseudo-phase) are fed the same draws: ``jax.random`` is patched to
return the port's ``torch.Generator`` draws.  Nothing in ``mdctgan_tpu/``
changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdctgan_tpu.ops import features as jfeat
from mdctgan_tpu.ops.mdct import IMDCT as JIMDCT
from mdctgan_tpu.ops.mdct import MDCT as JMDCT

from mdctgan_tpu_torch import generate_cli
from mdctgan_tpu_torch.ops import features as tfeat
from mdctgan_tpu_torch.ops import mdct as tmdct
from mdctgan_tpu_torch.ops import mdct_kernels as K

T = 4000  # not a multiple of any hop below: the end padding is exercised
FRAMINGS = {  # (n_fft, hop_length, win_length)
    "half": (128, 64, 128),
    "quarter": (128, 32, 128),
    "short_win": (128, 32, 64),
}
MODES = {
    "arcsinh": dict(arcsinh_transform=True),
    "explicit": dict(arcsinh_transform=False, explicit_encoding=True),
    "raw": dict(arcsinh_transform=False, raw_mdct=True),
    "db": dict(arcsinh_transform=False),
}
GRID = [(m, a, c, f) for m in MODES for a in (True, False) for c in (True, False)
        for f in FRAMINGS]


def _cfg(mode="arcsinh", abs_norm=True, center=True, framing="half", **extra):
    n_fft, hop, win = FRAMINGS[framing]
    return dict(n_fft=n_fft, hop_length=hop, win_length=win, center=center,
                segment_length=T, abs_norm=abs_norm, arcsinh_gain=1000.0,
                **MODES[mode], **extra)


def _pair(fields):
    jt = jfeat.SpectralTransform(jfeat.SpectralConfig(**fields), use_fused=False)
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**fields), "cpu")
    return jt, tt


def _audio(seed, b=2, t=T):
    return (0.1 * np.random.default_rng(seed).standard_normal((b, t))).astype(np.float32)


def _jax_param(p):
    if isinstance(p, float):
        return jnp.full((1, 1, 1, 1), p, jnp.float32)
    return jnp.asarray(p.numpy())


def _close(got, ref, rel, label=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, label
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{label}: max |err| {err} > {rel} x {scale}"


# --------------------------------------------------------------------------
# the matmul form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("framing", sorted(FRAMINGS) + ["odd_hop"])
def test_matmul_form_matches_jax(center, framing):
    """Spectrum at 1e-5 of its largest value, the inverse at 1e-4; a hop
    that does not divide the window frames forward (the JAX gather) and
    raises ``NotImplementedError`` inverse, on both sides."""
    n_fft, hop, win = FRAMINGS.get(framing, (128, 48, 128))
    x = _audio(1)
    ref = np.asarray(JMDCT(n_fft, hop, win, "kbd", center)(jnp.asarray(x)))
    fwd = tmdct.MDCT(n_fft, hop, win, center)
    got = fwd(torch.from_numpy(x))
    _close(got, ref, 1e-5, "spectrum")
    inv = tmdct.IMDCT(n_fft, hop, win, center)
    jinv = JIMDCT(n_fft, hop, win, "kbd", center)
    if win % hop:
        with pytest.raises(NotImplementedError):
            jinv(jnp.asarray(ref))
        with pytest.raises(NotImplementedError):
            inv(got)
        return
    _close(inv(got), jinv(jnp.asarray(ref)), 1e-4, "inverse")


def test_matmul_form_rejects_as_jax():
    for bad in (dict(win_length=256), dict(hop_length=256, win_length=128)):
        kw = {**dict(n_fft=128, hop_length=64, win_length=128), **bad}
        with pytest.raises(ValueError):
            JMDCT(kw["n_fft"], kw["hop_length"], kw["win_length"])
        with pytest.raises(ValueError):
            tmdct.MDCT(kw["n_fft"], kw["hop_length"], kw["win_length"])


def test_matmul_form_counts_its_calls():
    tmdct.reset_matmul_counts()
    fwd, inv = tmdct.MDCT(128, 32, 128), tmdct.IMDCT(128, 32, 128)
    inv(fwd(torch.zeros(1, 512)))
    fwd(torch.zeros(1, 512))
    assert tmdct.MATMULS == {"mdct_matmul": 2, "imdct_matmul": 1}


# --------------------------------------------------------------------------
# to_spectro and to_audio over the grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,abs_norm,center,framing", GRID)
def test_to_spectro_matches_jax(mode, abs_norm, center, framing):
    fields = _cfg(mode, abs_norm, center, framing)
    jt, tt = _pair(fields)
    assert tt.fused == jt._fused_compatible(jnp.float32)
    x = _audio(2)
    got, pha, params = tt.to_spectro(torch.from_numpy(x))
    spectro = tt.mdct(torch.from_numpy(x))[:, None]
    jt.mdct = lambda a: jnp.asarray(spectro[:, 0].numpy())  # the same spectrum
    ref, ref_pha, ref_params = jt.to_spectro(jnp.asarray(x))
    _close(got, ref, 1e-5, "normalized")
    for k in ("min", "max"):
        p = params[k]
        if abs_norm:
            assert isinstance(p, float) and p == float(ref_params[k].item())
        else:
            assert p.shape == (2, 2 if mode == "explicit" else 1, 1, 1)
            _close(p, ref_params[k], 1e-6, k)
    if mode == "db":  # the only mode whose pha to_audio reads
        np.testing.assert_array_equal(pha.numpy(), np.asarray(ref_pha))
    else:
        assert pha is None
    if mode in ("arcsinh", "raw"):  # end to end: the JAX package's own spectrum
        ref_e2e, _, _ = jfeat.SpectralTransform(jfeat.SpectralConfig(**fields),
                                                use_fused=False).to_spectro(jnp.asarray(x))
        _close(got, ref_e2e, 1e-5, "end to end")


@pytest.mark.parametrize("mode,abs_norm,center,framing", GRID)
def test_to_audio_matches_jax(mode, abs_norm, center, framing):
    """The same normalized input, bounds and LR sign on both sides; no
    generator, so the dB mode's pseudo-phase is ones."""
    fields = _cfg(mode, abs_norm, center, framing)
    jt, tt = _pair(fields)
    x = _audio(3)
    spec, pha, params = tt.to_spectro(torch.from_numpy(x))
    y = np.random.default_rng(4).uniform(-1, 1, spec.shape).astype(np.float32)
    got = tt.to_audio(torch.from_numpy(y), params, pha, out_length=T)
    ref = jt.to_audio(jnp.asarray(y), {k: _jax_param(v) for k, v in params.items()},
                      None if pha is None else jnp.asarray(pha.numpy()), out_length=T)
    _close(got, ref, 1e-4, "audio")


@pytest.mark.parametrize("abs_norm", [True, False])
@pytest.mark.parametrize("mode", ["arcsinh", "explicit", "raw"])
def test_round_trip(mode, abs_norm):
    """to_spectro -> to_audio gives the waveform back (1e-4) at the
    reconstructing framing, hop = win/2 centred; explicit through its
    recombination ``(s0 - s1)/(2 alpha - 1)``."""
    _, tt = _pair(_cfg(mode, abs_norm))
    x = _audio(5)
    spec, pha, params = tt.to_spectro(torch.from_numpy(x))
    back = tt.to_audio(spec, params, pha, out_length=T).numpy()
    np.testing.assert_allclose(back, x, atol=1e-4)


# --------------------------------------------------------------------------
# masks, pseudo-phase, g_input
# --------------------------------------------------------------------------

def _patched_normal(monkeypatch, draws):
    """``jax.random.normal`` returning ``draws`` for its shape (the fill),
    seeded noise otherwise (the pha jitter, which the port leaves out)."""
    real = np.random.default_rng(6)

    def normal(key, shape, dtype=jnp.float32):
        if tuple(shape) == tuple(draws.shape):
            return jnp.asarray(draws, dtype)
        return jnp.asarray(real.standard_normal(shape), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


@pytest.mark.parametrize("case", ["lr_zero", "lr_residual", "lr_noise", "hr_zero",
                                  "hr_noise", "fused_lr"])
def test_masks_match_jax(monkeypatch, case):
    """``lr_forward``/``hr_forward`` with ``mask``/``mask_hr``: zeros under
    ``fit_residual`` or without a generator, else the generator's normal
    noise over its range (fed to JAX through the patch); the fused
    configuration masks after K1 (its plain version here)."""
    hr = case.startswith("hr")
    noise = case.endswith("noise")
    fields = _cfg("arcsinh" if case == "fused_lr" else "db", case == "fused_lr",
                  sr_sampling_rate=32000, mask=not hr, mask_hr=hr,
                  fit_residual=case == "lr_residual")
    jt, tt = _pair(fields)
    assert tt.fused == (case == "fused_lr")
    assert tt.cfg.lr_mask_size == jt.cfg.lr_mask_size == 42
    assert tt.cfg.hr_mask_size == jt.cfg.hr_mask_size == 21
    x = _audio(7)
    gen = torch.Generator().manual_seed(11) if noise or case == "lr_residual" else None
    forward = "hr_forward" if hr else "lr_forward"
    got, _, _ = getattr(tt, forward)(torch.from_numpy(x), gen)
    size = tt.cfg.hr_mask_size if hr else tt.cfg.lr_mask_size
    shape = (*got.shape[:-1], size)
    if noise:
        draws = torch.randn(shape, generator=torch.Generator().manual_seed(11)).numpy()
        _patched_normal(monkeypatch, draws)
    else:
        assert not got[..., -size:].any()
    if not tt.fused:
        spectro = tt.mdct(torch.from_numpy(x))
        jt.mdct = lambda a: jnp.asarray(spectro.numpy())
    key = jax.random.PRNGKey(0) if gen is not None else None
    ref, _, _ = getattr(jt, forward)(jnp.asarray(x), rng=key)
    _close(got, ref, 1e-5, case)


@pytest.mark.parametrize("up", [3, 1])
def test_pseudo_phase_matches_jax(monkeypatch, up):
    """The dB mode's ``to_audio`` with a generator: the LR sign on the
    first ``F/up_ratio`` rows, the generator's +-1 above (fed to JAX
    through a patched ``randint``); none at ``up_ratio`` 1.  And
    ``generate_cli.phase_generators`` gives one seeded generator per batch
    exactly where the JAX CLI feeds a key."""
    fields = _cfg("db", False, lr_sampling_rate=48000 // up)
    jt, tt = _pair(fields)
    x = _audio(8)
    spec, pha, params = tt.to_spectro(torch.from_numpy(x))
    bits = torch.randint(0, 2, pha[:, 0].shape, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(bits.numpy()))
    got = tt.to_audio(spec, params, pha, torch.Generator().manual_seed(3), T)
    ref = jt.to_audio(jnp.asarray(spec.numpy()), {k: _jax_param(v) for k, v in params.items()},
                      jnp.asarray(pha.numpy()), rng=jax.random.PRNGKey(0), out_length=T)
    _close(got, ref, 1e-4, "audio")
    ones = tt.to_audio(spec, params, pha, None, T)
    assert (up == 1) == torch.equal(ones, got)
    phase = generate_cli.phase_generators(tt.cfg, 42)
    assert (phase is None) == (up == 1)
    if phase is not None:
        a, b = (torch.randint(0, 2, (64,), generator=phase(i)) for i in (0, 16))
        assert torch.equal(a, torch.randint(0, 2, (64,), generator=phase(0)))
        assert not torch.equal(a, b)
    for mode in ("arcsinh", "raw", "explicit"):
        assert generate_cli.phase_generators(tfeat.SpectralConfig(**_cfg(mode)), 42) is None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_g_input_adds_abs_channel_only_with_arcsinh(mode):
    """``--abs_spectro`` adds the abs channel only together with the arcsinh
    normalization, as the JAX package does: a dB model takes one channel."""
    jt, tt = _pair(_cfg(mode, abs_spectro=True))
    y = np.random.default_rng(9).uniform(-1, 1, (2, 1, 8, 16)).astype(np.float32)
    got = tt.g_input(torch.from_numpy(y))
    assert got.shape[1] == (2 if mode == "arcsinh" else 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt.g_input(jnp.asarray(y))))


# --------------------------------------------------------------------------
# the configuration and the choice of form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(), dict(center=False), dict(hop_length=128), dict(win_length=256),
    dict(center=False, segment_length=33024), dict(sr_sampling_rate=24000),
    dict(lr_sampling_rate=8000, n_fft=1024, hop_length=512, win_length=1024),
    dict(abs_norm=False), dict(arcsinh_transform=False), dict(raw_mdct=True),
    dict(explicit_encoding=True), dict(src_range=(5.0, -5.0)),
    dict(norm_range=(1.0, -1.0)),
])
def test_config_properties_and_form_match_jax(case):
    """``n_bins``, the mask sizes and the choice of K1/K2 (the JAX
    package's ``_fused_compatible``) on the flagship geometry and off it;
    the choice runs no transform: a fused configuration counts no matmul
    and an unfused one launches no kernel."""
    jcfg, tcfg = jfeat.SpectralConfig(**case), tfeat.SpectralConfig(**case)
    for prop in ("n_bins", "lr_mask_size", "hr_mask_size", "up_ratio"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    jt = jfeat.SpectralTransform(jcfg, use_fused=False)
    assert tfeat.fused_compatible(tcfg) == jt._fused_compatible(jnp.float32)
    assert not tfeat.fused_compatible(tcfg, torch.float64)
    tt = tfeat.SpectralTransform(tcfg, "cpu")
    tmdct.reset_matmul_counts()
    if tcfg.win_length % tcfg.hop_length == 0:
        x = torch.zeros(1, tcfg.segment_length)
        spec, pha, params = tt.to_spectro(x)
        assert spec.shape[-2] == tcfg.n_bins
        tt.to_audio(spec, params, pha)
    calls = tmdct.MATMULS["mdct_matmul"] + tmdct.MATMULS["imdct_matmul"]
    assert (calls == 0) == tt.fused


def test_kernel_wrappers_refuse_other_framings():
    """K1/K2's wrappers refuse a framing they do not compute, on any device
    (``tests/test_torch_cuda.py`` shows it on a CUDA tensor): the transform
    hands them its framing, so nothing reaches them but hop = win/2 = N."""
    x, mat, syn = torch.zeros(1, 512), K.spectro_matrix(128), K.synth_matrix(128)
    for hop, win in ((32, 128), (32, 64)):
        with pytest.raises(NotImplementedError):
            K.mdct_spectro(x, mat, 1000.0, hop_length=hop, win_length=win)
        with pytest.raises(NotImplementedError):
            K.imdct_audio(torch.zeros(1, 8, 64), syn, 1000.0, hop_length=hop, win_length=win)
    assert K.mdct_spectro(x, mat, hop_length=64, win_length=128).shape == (1, 9, 64)
