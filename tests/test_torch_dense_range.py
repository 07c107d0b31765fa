"""The dense form's range of N (``ops/mdct_kernels.py`` ``dense_max_n``) on
the CPU.

A block of the dense kernels (``csrc/window_gemm.cuh``) stages at least 17
hops of the source in shared memory, so N has a largest value on each
card.  The port decides it from the header's geometry before any launch:
the ops refuse a larger N with ``NotImplementedError`` for real and fake
tensors, ``fused_compatible`` gives it the matmul form, and ``--fused_mdct
on`` raises.  The Python mirror of ``smem_bytes`` is held to the header's
own text, evaluated.  The kernels at N 4096, at the limit and at 32 are
held on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mdctgan_tpu.ops import features as jfeat

from mdctgan_tpu_torch.ops import features as tfeat
from mdctgan_tpu_torch.ops import mdct as tmdct
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.options import spectral_config_from_opt

HEADER = Path(K.__file__).resolve().parent.parent / "csrc" / "window_gemm.cuh"
LIMIT = 5568  # sm_90: 227 KB a block; 17 x (2784 + 4) floats of source + the ring


def _header_functions():
    """``hop_pad``, ``span_pitch`` and ``smem_bytes`` of the header, their C
    bodies turned into Python over its namespace's ``constexpr int``
    constants."""
    text = HEADER.read_text()
    ns = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        ns[name] = eval(expr.replace("/", "//"), {}, dict(ns))
    for name, args, body in re.findall(
            r"inline (?:int|size_t) (hop_pad|span_pitch|smem_bytes)\(([^)]*)\) \{(.*?)\n?\}",
            text, re.S):
        params = ", ".join(a.split()[-1] for a in args.split(","))
        lines = [ln.strip().rstrip(";") for ln in body.strip().split(";\n")]
        py = []
        for ln in lines:
            ln = ln.rstrip(";").replace("const int ", "").replace("sizeof(float)", "4")
            ln = re.sub(r"\((\w+) > (\w+) \? \1 : \2\)", r"max(\1, \2)", ln)
            py.append("    " + ln.replace(" / ", " // "))
        exec(f"def {name}({params}):\n" + "\n".join(py), ns)
    return ns


def test_python_limit_matches_the_header():
    """The mirror's constants are the header's, ``dense_smem_bytes(bm, hop)``
    is the header's ``smem_bytes`` at every hop up to past the limit, the
    fewest rows a block takes is the launcher's smallest BM, and the limit
    on sm_90 is 5568."""
    h = _header_functions()
    assert (K.DENSE_BN, K.DENSE_BK, K.DENSE_THREADS, K.DENSE_STAGES, K.DENSE_STAGE_FLOATS,
            K.DENSE_RED_PITCH) == (h["BN"], h["BK"], h["THREADS"], h["STAGES"],
                                   h["STAGE_FLOATS"], h["RED_PITCH"])
    for bm in (16, 32, 64):
        for hop in range(1, 3200):
            assert K.dense_smem_bytes(bm, hop) == h["smem_bytes"](bm, hop), (bm, hop)
    cands = re.search(r"for \(int cand : \{([\d, ]+)\}\)", HEADER.read_text()).group(1)
    assert K.DENSE_MIN_BM == min(int(c) for c in cands.split(","))
    assert K.dense_max_n() == K.dense_max_n("cpu") == LIMIT
    assert h["smem_bytes"](16, LIMIT // 2) <= K.SM90_SMEM_OPTIN < h["smem_bytes"](16, LIMIT // 2 + 1)


def test_limit_follows_the_cards_shared_memory(monkeypatch):
    """On a CUDA device the limit is read from the card: 99 KB a block (an
    sm_86 card) admits N up to 1728."""
    props = type("Props", (), {"shared_memory_per_block_optin": 101376})()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: props)
    K._card_smem_optin.cache_clear()
    try:
        assert K.dense_max_n(torch.device("cuda", 0)) == 1728
    finally:
        K._card_smem_optin.cache_clear()
    assert K.dense_smem_bytes(16, 864) <= 101376 < K.dense_smem_bytes(16, 865)


@pytest.mark.parametrize("kernel", ["mdct_spectro", "imdct_audio"])
@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_ops_refuse_above_the_limit(kernel, fake):
    """N at the limit passes the ops' checks (a 9-frame row on the CPU runs
    the plain version; a fake tensor gets its shape); the next even N raises
    ``NotImplementedError`` before anything is computed, for real and for
    fake tensors, and so does N 8192."""

    def call(n, inputs):
        k = n // 2
        if kernel == "mdct_spectro":
            return torch.ops.mdctgan.mdct_spectro(inputs(2, 8 * k), inputs(n, k),
                                                  1000.0, 0.2, 0.0, k, n)
        return torch.ops.mdctgan.imdct_audio(inputs(2, 9, k), inputs(k, n), 1000.0, 5.0, 0.0,
                                             k, n)

    mode = FakeTensorMode() if fake else None
    with mode or torch.no_grad():
        out = call(LIMIT, torch.zeros)
        assert out.shape == ((2, 9, LIMIT // 2) if kernel == "mdct_spectro"
                             else (2, 8 * LIMIT // 2))
        for n in (LIMIT + 2, 8192):
            with pytest.raises(NotImplementedError, match="above the dense form"):
                call(n, torch.zeros)


def _cfg(n_fft, **extra):
    return dict(n_fft=n_fft, hop_length=n_fft // 2, win_length=n_fft,
                segment_length=4 * n_fft, **extra)


@pytest.mark.parametrize("n_fft,fused", [(4096, True), (LIMIT, True), (LIMIT + 2, False),
                                         (8192, False)])
def test_fused_compatible_stops_at_the_limit(n_fft, fused):
    """K1/K2 serve the flagship's normalization up to the limit; above it
    the transform takes the matmul form from the configuration, where the
    JAX package's ``_fused_compatible`` (which has no limit) says fused."""
    cfg = tfeat.SpectralConfig(**_cfg(n_fft))
    assert tfeat.fused_compatible(cfg) is fused
    assert tfeat.SpectralTransform(cfg, "cpu").fused is fused
    jt = jfeat.SpectralTransform(jfeat.SpectralConfig(**_cfg(n_fft)), use_fused=False)
    assert jt._fused_compatible(jnp.float32)


def test_fused_mdct_on_raises_above_the_limit():
    """``--fused_mdct on`` raises at option time above the limit and takes
    the limit itself; ``auto`` gives the matmul form there."""
    assert spectral_config_from_opt(dict(_cfg(LIMIT), fused_mdct="on")).n_fft == LIMIT
    for n in (LIMIT + 2, 8192):
        with pytest.raises(ValueError, match=f"n_fft at most {LIMIT}"):
            spectral_config_from_opt(dict(_cfg(n), fused_mdct="on"))
        assert not tfeat.fused_compatible(spectral_config_from_opt(dict(_cfg(n))))


def test_fused_mdct_on_takes_the_named_cards_limit(monkeypatch):
    """Where ``--gpu_ids`` names a card of this host, ``--fused_mdct on``
    is held to that card's limit: on a 99 KB card (1728) n_fft 4096 raises,
    which sm_90's limit admits; with ``--gpu_ids -1`` (the CPU) or a card
    this host lacks, sm_90's limit holds."""
    props = type("Props", (), {"shared_memory_per_block_optin": 101376})()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: props)
    K._card_smem_optin.cache_clear()
    try:
        with pytest.raises(ValueError, match="n_fft at most 1728"):
            spectral_config_from_opt(dict(_cfg(4096), fused_mdct="on", gpu_ids=[0]))
        assert spectral_config_from_opt(dict(_cfg(1728), fused_mdct="on",
                                             gpu_ids=[0])).n_fft == 1728
        for ids in ([], [1]):
            assert spectral_config_from_opt(dict(_cfg(4096), fused_mdct="on",
                                                 gpu_ids=ids)).n_fft == 4096
    finally:
        K._card_smem_optin.cache_clear()


def test_n8192_runs_the_matmul_form_as_jax():
    """``SpectralTransform(device="cpu")`` at n_fft 8192 against the JAX
    package's XLA path on the same seeded input, at the matmul form's
    tolerances of ``tests/test_torch_spectral_modes.py``: the spectrum 1e-5
    of its largest value, its normalization on the same spectrum 1e-5, the
    inverse and the audio from a normalized input 1e-4.  (End to end the
    normalized values part by ~4e-4 of their largest: two float32 sums of
    8192 products in different orders, read at the arcsinh's slope of ~87
    near zero.)  The matmul form counts its calls and no kernel is
    reached."""
    fields = _cfg(8192, arcsinh_gain=1000.0)
    jt = jfeat.SpectralTransform(jfeat.SpectralConfig(**fields), use_fused=False)
    tt = tfeat.SpectralTransform(tfeat.SpectralConfig(**fields), "cpu")
    assert not tt.fused
    x = (0.1 * np.random.default_rng(11).standard_normal((2, 4 * 8192))).astype(np.float32)

    def close(got, ref, rel):
        ref = np.asarray(ref)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.shape == ref.shape
        assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max())

    tmdct.reset_matmul_counts()
    K.reset_launch_counts()
    spectro = tt.mdct(torch.from_numpy(x))
    close(spectro, jt.mdct(jnp.asarray(x)), 1e-5)
    close(tt.imdct(spectro), jt.imdct(jnp.asarray(spectro.numpy())), 1e-4)
    got, pha, params = tt.to_spectro(torch.from_numpy(x))
    jt.mdct = lambda a: jnp.asarray(spectro.numpy())  # the same spectrum
    close(got, jt.to_spectro(jnp.asarray(x))[0], 1e-5)
    y = np.random.default_rng(12).uniform(-1, 1, got.shape).astype(np.float32)
    audio = tt.to_audio(torch.from_numpy(y), params, pha, out_length=x.shape[1])
    close(audio, jt.to_audio(
        jnp.asarray(y), {k: jnp.full((1, 1, 1, 1), v, jnp.float32) for k, v in params.items()},
        None, out_length=x.shape[1]), 1e-4)
    assert tmdct.MATMULS == {"mdct_matmul": 2, "imdct_matmul": 2}
    assert all(n == 0 for n in K.LAUNCHES.values())
