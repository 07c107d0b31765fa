"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device).  This file imports neither JAX nor the reference
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mdctgan_tpu_torch import api
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

GAIN = 1000.0
SMALL_OPT = dict(
    n_fft=128, hop_length=64, win_length=128, segment_length=8128, bins=128,
    netG="local", ngf=4, n_downsample_global=2, n_blocks_global=1,
    n_blocks_local=1, n_blocks_attn_g=1, heads_g=2, dim_head_g=4,
    downsample_type="resconv", upsample_type="interpolate",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensor_launches_kernel_or_raises(cuda):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 32512)).astype(np.float32))
    mat = K.spectro_matrix(512)
    K.reset_launch_counts()
    got = K.mdct_spectro(x.to(cuda), mat.to(cuda), GAIN, 0.2, 0.0)
    assert K.LAUNCHES["mdct_spectro"] == 1
    ref = K.mdct_spectro_plain(x.double(), mat.double(), GAIN, 0.2, 0.0)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=5e-4)
    y = torch.from_numpy(rng.uniform(-1, 1, (8, 128, 256)).astype(np.float32))
    syn = K.synth_matrix(512)
    got2 = K.imdct_audio(y.to(cuda), syn.to(cuda), GAIN, 5.0, 0.0)
    assert K.LAUNCHES["imdct_audio"] == 1
    ref2 = K.imdct_audio_plain(y.double(), syn.double(), GAIN, 5.0, 0.0)
    np.testing.assert_allclose(got2.cpu().numpy(), ref2.numpy(), atol=1e-3)
    # a CUDA tensor is never handed to the plain version: what the kernel
    # does not take raises
    with pytest.raises(ValueError):
        K.mdct_spectro(x.double().to(cuda), mat.double().to(cuda), GAIN)
    with pytest.raises(ValueError):
        K.imdct_audio(y.to(cuda), syn, GAIN)  # matrix left on the CPU
    assert K.LAUNCHES == {"mdct_spectro": 1, "imdct_audio": 1,
                          "mdct_spectro_dense": 0, "imdct_audio_dense": 0}


def _k1_k2_against_float64(cuda, rng, n_fft, t, frames, kernel_names):
    """K1 and K2 on the card against their plain versions in float64, at
    the bounds of the f32 parity tests, launching only ``kernel_names``.
    The signal is scaled by sqrt(512/N) so that a frame carries the same
    energy at every N: the arcsinh's slope of ~87 near 0 reads the
    spectrum's absolute rounding, which grows with the frame's norm."""
    m_pts = n_fft // 2
    mat, syn = K.spectro_matrix(n_fft, cuda), K.synth_matrix(n_fft, cuda)
    mat64 = K.spectro_matrix(n_fft, dtype=torch.float64)
    syn64 = K.synth_matrix(n_fft, dtype=torch.float64)
    x = (rng.standard_normal((2, t)) * np.sqrt(512 / n_fft)).astype(np.float32)
    x64 = torch.from_numpy(x).double()
    K.reset_launch_counts()
    got = K.mdct_spectro(torch.from_numpy(x).to(cuda), mat, GAIN, 0.2, 0.0).cpu().double()
    ref = K.mdct_spectro_plain(x64, mat64, GAIN, 0.2, 0.0)
    assert got.shape == ref.shape == (2, K.n_frames_of(t, m_pts), m_pts)
    assert float((got - ref).abs().max()) <= 5e-4
    got = K.mdct_spectro(torch.from_numpy(x).to(cuda), mat).cpu().double()
    assert float((got - K.mdct_spectro_plain(x64, mat64)).abs().max()) <= 2e-3
    y = rng.uniform(-1, 1, (2, frames, m_pts)).astype(np.float32)
    y64 = torch.from_numpy(y).double()
    got = K.imdct_audio(torch.from_numpy(y).to(cuda), syn, GAIN, 5.0, 0.0).cpu().double()
    ref = K.imdct_audio_plain(y64, syn64, GAIN, 5.0, 0.0)
    assert got.shape == ref.shape == (2, (frames - 1) * m_pts)
    assert float((got - ref).abs().max()) <= 1e-3
    s = rng.standard_normal((2, frames, m_pts)).astype(np.float32)
    got = K.imdct_audio(torch.from_numpy(s).to(cuda), syn).cpu().double()
    ref = K.imdct_audio_plain(torch.from_numpy(s).double(), syn64)
    assert float((got - ref).abs().max()) <= 1e-4
    a = (0.1 * rng.standard_normal((2, t))).astype(np.float32)
    back = K.imdct_audio(K.mdct_spectro(torch.from_numpy(a).to(cuda), mat, GAIN, 0.1, 0.0),
                         syn, GAIN, 10.0, 0.0)
    torch.cuda.synchronize()
    assert float((back.cpu()[:, :t] - torch.from_numpy(a)).abs().max()) <= 1e-4
    assert {k for k, v in K.LAUNCHES.items() if v} == set(kernel_names)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [64, 128, 512, 2048])
def test_fft_kernels_match_float64_plain(cuda, n_fft):
    rng = np.random.default_rng(n_fft)
    _k1_k2_against_float64(cuda, rng, n_fft, 32512, 40,
                           ("mdct_spectro", "imdct_audio"))


@pytest.mark.cuda
def test_dense_kernels_match_float64_plain(cuda):
    # N = 480 (hop 240) is not a power of two: the wrappers pick the dense form
    rng = np.random.default_rng(480)
    _k1_k2_against_float64(cuda, rng, 480, 24000, 100,
                           ("mdct_spectro_dense", "imdct_audio_dense"))


@pytest.mark.cuda
def test_small_model_serves_through_kernels(cuda):
    rng = np.random.default_rng(1)
    params, stats = random_jax_trees(build_generator(SMALL_OPT), rng)
    state = state_dict_from_jax(params, stats)
    on_card = api.create_model(SMALL_OPT, device=cuda, state_dict=state)
    on_cpu = api.create_model(SMALL_OPT, device="cpu", state_dict=state)
    clip = (0.1 * rng.standard_normal(12000)).astype(np.float32)
    K.reset_launch_counts()
    got = api.upsample(clip, 16000, on_card, is_lr_input=True, gen_overlap=256,
                       batch_size=2)
    assert K.LAUNCHES["mdct_spectro"] > 0 and K.LAUNCHES["imdct_audio"] > 0
    ref = api.upsample(clip, 16000, on_cpu, is_lr_input=True, gen_overlap=256,
                       batch_size=2)
    assert got.shape == ref.shape == (36000,)
    np.testing.assert_allclose(got, ref, atol=2e-3 * float(np.abs(ref).max()))
