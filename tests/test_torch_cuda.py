"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device).  This file imports neither JAX nor the reference
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import csv
import functools
import math
import wave

import numpy as np
import pytest
import torch

from mdctgan_tpu_torch import api, generate_cli
from mdctgan_tpu_torch.data import native
from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.options import TrainOptions, spectral_config_from_opt
from mdctgan_tpu_torch.train.import_torch import export_to_torch_keys, generator_entries_for
from mdctgan_tpu_torch.train.schedule import OptimizerSpec
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_inference_fn, build_train_step
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


@pytest.mark.cuda
def test_matmul_form_on_card_matches_cpu(cuda):
    """A configuration K1/K2 do not serve (dB, per-sample min/max, no
    centring, hop = win/4) runs the matmul form on the card, never a
    kernel, and agrees with its CPU run under the float32 policy: the
    normalized spectrum within 1e-5 of its largest value on the same
    spectrum, the spectrum and the audio within 1e-5 and 1e-4."""
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.ops import mdct as M
    from mdctgan_tpu_torch.ops.features import SpectralConfig

    cfg = SpectralConfig(n_fft=512, hop_length=128, win_length=512, center=False,
                         arcsinh_transform=False, abs_norm=False, segment_length=32768)
    x = torch.from_numpy(0.1 * np.random.default_rng(3).standard_normal((4, 32768)).astype(
        np.float32))
    card, cpu = SpectralTransform(cfg, cuda), SpectralTransform(cfg, "cpu")
    assert not card.fused
    K.reset_launch_counts()
    M.reset_matmul_counts()
    with float32_policy():
        spec_card, spec_cpu = card.mdct(x.to(cuda)), cpu.mdct(x)
        norm_card, pha, params = card.to_spectro(x.to(cuda))
        norm_cpu = cpu.normalize(spec_card.cpu()[:, None])[0]
        audio_card = card.to_audio(norm_card, params, pha)
        audio_cpu = cpu.to_audio(norm_card.cpu(), {k: v.cpu() for k, v in params.items()},
                                 pha.cpu())
    for got, ref, rel in ((spec_card, spec_cpu, 1e-5), (norm_card, norm_cpu, 1e-5),
                          (audio_card, audio_cpu, 1e-4)):
        err = float((got.cpu() - ref).abs().max())
        assert err <= rel * float(ref.abs().max()), (err, rel)
    assert all(n == 0 for n in K.LAUNCHES.values())
    assert M.MATMULS == {"mdct_matmul": 3, "imdct_matmul": 2}


@pytest.mark.cuda
def test_k1_wrapper_refuses_quarter_hop_on_card(cuda):
    """K1's wrapper, handed hop = win/4 on a CUDA tensor, raises and
    launches nothing: no framing it does not compute falls back to another
    path (the transform runs the matmul form for it, chosen from the
    configuration)."""
    x = torch.zeros(2, 32512, device=cuda)
    mat = K.spectro_matrix(512, cuda)
    K.reset_launch_counts()
    with pytest.raises(NotImplementedError):
        K.mdct_spectro(x, mat, GAIN, 0.2, 0.0, hop_length=128, win_length=512)
    with pytest.raises(NotImplementedError):
        K.imdct_audio(torch.zeros(2, 128, 256, device=cuda), K.synth_matrix(512, cuda), GAIN,
                      hop_length=128, win_length=512)
    assert all(n == 0 for n in K.LAUNCHES.values())


def _k1_k2_against_float64(cuda, rng, n_fft, t, frames, kernel_names, batch=2):
    """K1 and K2 on the card against their plain versions in float64, at
    the bounds of the f32 parity tests, launching only ``kernel_names``.
    The signal is scaled by sqrt(512/N) so that a frame carries the same
    energy at every N: the arcsinh's slope of ~87 near 0 reads the
    spectrum's absolute rounding, which grows with the frame's norm."""
    m_pts = n_fft // 2
    mat, syn = K.spectro_matrix(n_fft, cuda), K.synth_matrix(n_fft, cuda)
    mat64 = K.spectro_matrix(n_fft, dtype=torch.float64)
    syn64 = K.synth_matrix(n_fft, dtype=torch.float64)
    x = (rng.standard_normal((batch, t)) * np.sqrt(512 / n_fft)).astype(np.float32)
    x64 = torch.from_numpy(x).double()
    K.reset_launch_counts()
    got = K.mdct_spectro(torch.from_numpy(x).to(cuda), mat, GAIN, 0.2, 0.0).cpu().double()
    ref = K.mdct_spectro_plain(x64, mat64, GAIN, 0.2, 0.0)
    assert got.shape == ref.shape == (batch, K.n_frames(t, 2 * m_pts, m_pts), m_pts)
    assert float((got - ref).abs().max()) <= 5e-4
    got = K.mdct_spectro(torch.from_numpy(x).to(cuda), mat).cpu().double()
    assert float((got - K.mdct_spectro_plain(x64, mat64)).abs().max()) <= 2e-3
    y = rng.uniform(-1, 1, (batch, frames, m_pts)).astype(np.float32)
    y64 = torch.from_numpy(y).double()
    got = K.imdct_audio(torch.from_numpy(y).to(cuda), syn, GAIN, 5.0, 0.0).cpu().double()
    ref = K.imdct_audio_plain(y64, syn64, GAIN, 5.0, 0.0)
    assert got.shape == ref.shape == (batch, (frames - 1) * m_pts)
    assert float((got - ref).abs().max()) <= 1e-3
    s = rng.standard_normal((batch, frames, m_pts)).astype(np.float32)
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
@pytest.mark.parametrize("n_fft,t,frames,batch", [(480, 24000, 100, 2), (960, 60960, 128, 8),
                                                  (200, 24000, 100, 2), (4096, 16384, 8, 2),
                                                  ("limit", None, 8, 2), (32, 24000, 100, 2)])
def test_dense_kernels_match_float64_plain(cuda, n_fft, t, frames, batch):
    # N = 480, 960 (hops of 10 ms at 24 and 48 kHz) and 200 (N/2 not a
    # multiple of 8) are not powers of two: the wrappers pick the dense form;
    # so they do for 4096 (a power of two above the FFT form's 2048), for the
    # largest N the dense form takes on this card ("limit": 5568 on an H100,
    # T = 8 hops) and for 32 (below 64)
    if n_fft == "limit":
        n_fft = K.dense_max_n(cuda)
        if "H100" in torch.cuda.get_device_name(cuda):
            assert n_fft == 5568
        t = 8 * (n_fft // 2)
    rng = np.random.default_rng(n_fft)
    _k1_k2_against_float64(cuda, rng, n_fft, t, frames,
                           ("mdct_spectro_dense", "imdct_audio_dense"), batch)


@pytest.mark.cuda
def test_dense_range_is_refused_before_any_launch(cuda):
    """Above ``dense_max_n`` of the card (5568 on an H100) both wrappers
    raise ``NotImplementedError`` from the shape checks, and nothing is
    launched."""
    top = K.dense_max_n(cuda)
    if "H100" in torch.cuda.get_device_name(cuda):
        assert top == 5568
    n, k = top + 2, top // 2 + 1
    K.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="above the dense form"):
        K.mdct_spectro(torch.zeros(2, 8 * k, device=cuda), torch.zeros(n, k, device=cuda))
    with pytest.raises(NotImplementedError, match="above the dense form"):
        K.imdct_audio(torch.zeros(2, 9, k, device=cuda), torch.zeros(k, n, device=cuda))
    assert all(v == 0 for v in K.LAUNCHES.values())


@pytest.mark.cuda
def test_dense_form_forced_at_n512_matches_fft_form(cuda):
    """At n_fft 512, batch 8, the dense form (forced) against the FFT form
    the wrappers pick there, on the same inputs: K1 within 5e-4 normalized,
    K2 within 1e-3, the float32 parity bounds, each form launched once.
    K1's input is noise at sigma 0.25 (audio within [-1, 1]), as
    ``chip_smoke.py`` holds a float32 kernel to another float32 version:
    on unit-variance noise each is itself up to ~3e-4 from float64."""
    rng = np.random.default_rng(512)
    x = torch.from_numpy((0.25 * rng.standard_normal((8, 32512))).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.uniform(-1, 1, (8, 128, 256)).astype(np.float32)).to(cuda)
    mat, syn = K.spectro_matrix(512, cuda), K.synth_matrix(512, cuda)
    K.reset_launch_counts()
    fft1, dense1 = (K.mdct_spectro(x, mat, GAIN, 0.2, 0.0),
                    K.mdct_spectro_dense(x, mat, GAIN, 0.2, 0.0))
    fft2, dense2 = (K.imdct_audio(y, syn, GAIN, 5.0, 0.0),
                    K.imdct_audio_dense(y, syn, GAIN, 5.0, 0.0))
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"mdct_spectro": 1, "imdct_audio": 1,
                          "mdct_spectro_dense": 1, "imdct_audio_dense": 1}
    assert float((dense1 - fft1).abs().max()) <= 5e-4
    assert float((dense2 - fft2).abs().max()) <= 1e-3


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


@pytest.mark.cuda
def test_small_bf16_generator_on_card_against_float64(cuda):
    """The small generator under ``fp16`` (eval mode) on the card and on the
    CPU against the float64 generator on the same weights: float32 logits
    come back, and the card's error is within 2x the CPU's bf16 error, by
    max and by RMS (the bound of ``chip_smoke.py`` phase 6b)."""
    rng = np.random.default_rng(3)
    state = state_dict_from_jax(*random_jax_trees(build_generator(SMALL_OPT), rng))
    x = torch.from_numpy(rng.standard_normal((2, 2, 128, 64)).astype(np.float32))
    nets = {}
    for name, opt in (("card", dict(SMALL_OPT, fp16=True)), ("cpu", dict(SMALL_OPT, fp16=True)),
                      ("truth", SMALL_OPT)):
        nets[name] = build_generator(opt)
        nets[name].load_state_dict(state, strict=True)
        nets[name].eval()
    with torch.no_grad():
        card = nets["card"].to(cuda).logits(x.to(cuda)).cpu()
        cpu = nets["cpu"].logits(x)
        truth = nets["truth"].double().logits(x.double())
    assert card.dtype == cpu.dtype == torch.float32
    errs = {name: (float((v.double() - truth).abs().max()),
                   float((v.double() - truth).pow(2).mean().sqrt()))
            for name, v in (("card", card), ("cpu", cpu))}
    assert errs["card"][0] <= 2 * errs["cpu"][0] and errs["card"][1] <= 2 * errs["cpu"][1], errs


@pytest.mark.cuda
def test_small_train_step_on_card_matches_cpu(cuda):
    """Three SGD(1) steps of the small G and D on the card and on the CPU
    from the same weights: the first step's losses agree within 1e-3
    relative and its updates (the gradients) within 2e-3 normwise (floor
    5e-5); K1 launched twice a step, K2 never."""
    opt = dict(SMALL_OPT, ndf=4, n_layers_D=2, num_D=2)
    rng = np.random.default_rng(2)
    g_state = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
    d_state = state_dict_from_jax(*random_jax_trees(build_discriminator(opt), rng))
    hr = (0.1 * rng.standard_normal((3, 8128))).astype(np.float32)
    lr = (hr + 0.01 * rng.standard_normal((3, 8128))).astype(np.float32)
    sgd = OptimizerSpec(functools.partial(torch.optim.SGD, lr=1.0))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        gen, disc = build_generator(opt), build_discriminator(opt)
        gen.load_state_dict(g_state, strict=True)
        disc.load_state_dict(d_state, strict=True)
        state = create_train_state(gen, disc, sgd, sgd, device=dev)
        step = build_train_step(SpectralTransform(spectral_config_from_opt(opt), dev), sgd, sgd,
                                n_layers_d=2, num_d=2)
        batch = {"lr_audio": torch.from_numpy(lr).to(dev), "hr_audio": torch.from_numpy(hr).to(dev)}
        K.reset_launch_counts()
        losses = []
        for i in range(3):
            state, metrics = step(state, batch)
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                after = {k: v.detach().cpu().clone() for k, v in
                         list(gen.named_parameters()) + list(disc.named_parameters())}
        runs[dev.type] = losses, after, dict(K.LAUNCHES)
    (card_losses, card_after, launches), (cpu_losses, cpu_after, _) = runs["cuda"], runs["cpu"]
    assert launches == {"mdct_spectro": 6, "imdct_audio": 0, "mdct_spectro_dense": 0,
                        "imdct_audio_dense": 0}
    for k, ref in cpu_losses[0].items():
        assert card_losses[0][k] == pytest.approx(ref, rel=1e-3), k
    before = {**g_state, **d_state}
    for k, ref in cpu_after.items():
        ref_grad, got_grad = before[k] - ref, before[k] - card_after[k]
        err = float((got_grad - ref_grad).norm())
        assert err <= 2e-3 * float(ref_grad.norm()) + 5e-5, k


@pytest.mark.cuda
def test_small_generate_cli_on_card_matches_cpu(cuda, tmp_path):
    """The generate CLI in batch mode at small geometry (``netG global``,
    transconv up) on the card and on the CPU from one reference-layout
    ``.pth``: the SR WAVs within 2e-3 of their largest value, LSD 1e-3
    relative, each SNR 0.01 dB; K1 and K2 launched once per batch each."""
    flags = ["--lr_sampling_rate", "16000", "--center", "--arcsinh_transform",
             "--abs_spectro", "--abs_norm", "--norm_range", "-1", "1", "--fit_residual",
             "--netG", "global", "--ngf", "4", "--n_downsample_global", "2",
             "--n_blocks_global", "1", "--n_blocks_attn_g", "1", "--heads_g", "2",
             "--dim_head_g", "4", "--segment_length", "8128", "--n_fft", "128",
             "--hop_length", "64", "--win_length", "128", "--bins", "128",
             "--batchSize", "2", "--checkpoints_dir", str(tmp_path / "out")]
    rng = np.random.default_rng(3)
    gen = build_generator(TrainOptions().parse(flags, save=False))
    state = state_dict_from_jax(*random_jax_trees(gen, rng))
    state["head.conv.weight"] *= 0.01  # SR within full scale, as a trained model's
    (tmp_path / "pre").mkdir()
    torch.save(export_to_torch_keys(state, generator_entries_for(gen)),
               tmp_path / "pre" / "latest_net_G.pth")
    (tmp_path / "wavs").mkdir()
    lengths = (14000, 20000, 30000)
    for i, n in enumerate(lengths):
        native.write_wav16(str(tmp_path / "wavs" / f"s{i}.wav"),
                           (0.1 * rng.standard_normal(n)).astype(np.float32), 48000)
    common = flags + ["--dataroot", str(tmp_path / "wavs"),
                      "--load_pretrain", str(tmp_path / "pre")]
    K.reset_launch_counts()
    card = generate_cli.main(common + ["--name", "card", "--gpu_ids", "0"])
    launches = dict(K.LAUNCHES)
    cpu = generate_cli.main(common + ["--name", "cpu", "--gpu_ids", "-1"])
    batches = sum(math.ceil(math.ceil(n / 8128) / 2) for n in lengths)
    assert launches == {"mdct_spectro": batches, "imdct_audio": batches,
                        "mdct_spectro_dense": 0, "imdct_audio_dense": 0}
    assert card["rungs"] == cpu["rungs"] == []
    for got, ref in zip(card["rows"], cpu["rows"]):
        assert got["output"] == ref["output"]
        for k in ("snr_sr", "snr_lr", "snr_seg"):
            assert abs(got[k] - ref[k]) <= 0.01, k
        assert abs(got["lsd"] - ref["lsd"]) <= 1e-3 * ref["lsd"]
        assert abs(got["mse"] - ref["mse"]) <= 1e-2 * ref["mse"]
        wavs = []
        for side in ("card", "cpu"):
            with wave.open(str(tmp_path / "out" / side / got["output"])) as w:
                wavs.append(np.frombuffer(w.readframes(w.getnframes()), "<i2") / 32768.0)
        assert wavs[0].shape == wavs[1].shape
        assert float(np.abs(wavs[0] - wavs[1]).max()) <= 2e-3 * float(np.abs(wavs[1]).max())
    with open(tmp_path / "out" / "card" / "metrics.csv") as f:
        assert [r["file"] for r in csv.DictReader(f)][-1] == "MEAN"


@pytest.mark.cuda
def test_small_train_cli_on_card_matches_cpu(cuda, tmp_path):
    """The train CLI at small geometry on the card and on the CPU from the
    same reference-layout G and D: the first step's losses within 1e-3
    relative; K1 launched 2 times a step, once an eval batch and 3 times a
    display, K2 once an eval batch and once a display, the dense forms
    never."""
    from mdctgan_tpu_torch import train_cli
    from mdctgan_tpu_torch.train.import_torch import discriminator_entries

    flags = ["--lr_sampling_rate", "16000", "--center", "--arcsinh_transform",
             "--abs_spectro", "--abs_norm", "--norm_range", "-1", "1", "--fit_residual",
             "--netG", "global", "--ngf", "4", "--n_downsample_global", "2",
             "--n_blocks_global", "1", "--n_blocks_attn_g", "1", "--heads_g", "2",
             "--dim_head_g", "4", "--segment_length", "8128", "--n_fft", "128",
             "--hop_length", "64", "--win_length", "128", "--bins", "128",
             "--num_D", "2", "--n_layers_D", "2", "--ndf", "4", "--batchSize", "2",
             "--checkpoints_dir", str(tmp_path / "out")]
    opt = TrainOptions().parse(flags, save=False)
    rng = np.random.default_rng(4)
    gen, disc = build_generator(opt), build_discriminator(opt)
    g_state = state_dict_from_jax(*random_jax_trees(gen, rng))
    g_state["head.conv.weight"] *= 0.01
    d_state = state_dict_from_jax(*random_jax_trees(disc, rng))
    (tmp_path / "pre").mkdir()
    torch.save(export_to_torch_keys(g_state, generator_entries_for(gen)),
               tmp_path / "pre" / "latest_net_G.pth")
    torch.save(export_to_torch_keys(d_state, discriminator_entries(2, 2)),
               tmp_path / "pre" / "latest_net_D.pth")
    for split, n in (("train", 4), ("eval", 3)):
        (tmp_path / split).mkdir()
        for i in range(n):
            native.write_wav16(str(tmp_path / split / f"s{i}.wav"),
                               (0.1 * rng.standard_normal(12000 + 1000 * i)).astype(np.float32),
                               48000)
    common = flags + [
        "--dataroot", str(tmp_path / "train"), "--evalroot", str(tmp_path / "eval"),
        "--load_pretrain", str(tmp_path / "pre"), "--serial_batches", "--deterministic_eval",
        "--niter", "1", "--niter_decay", "0", "--print_freq", "2", "--display_freq", "2",
        "--eval_freq", "4", "--eval_size", "3", "--save_latest_freq", "1000000",
        "--no_html", "--nThreads", "1"]
    K.reset_launch_counts()
    card = train_cli.main(common + ["--name", "card", "--gpu_ids", "0"])
    launches = dict(K.LAUNCHES)
    cpu = train_cli.main(common + ["--name", "cpu", "--gpu_ids", "-1"])
    steps, evals, displays = 2, 2, 2
    assert card["launches"] == launches == {
        "mdct_spectro": 2 * steps + evals + 3 * displays, "imdct_audio": evals + displays,
        "mdct_spectro_dense": 0, "imdct_audio_dense": 0}
    for k, ref in cpu["losses"][0].items():
        assert card["losses"][0][k] == pytest.approx(ref, rel=1e-3), k


def _small_pth(tmp_path, rng):
    """Seeded small ``netG local`` weights (whose coarse branch is named
    ``global``) as a reference-layout ``.pth``; the export flags, options
    and state dict."""
    flags = ["--lr_sampling_rate", "16000", "--center", "--arcsinh_transform",
             "--abs_spectro", "--abs_norm", "--norm_range", "-1", "1", "--fit_residual",
             "--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
             "--n_blocks_global", "1", "--n_blocks_local", "1", "--n_blocks_attn_g", "1",
             "--heads_g", "2", "--dim_head_g", "4", "--segment_length", "8128",
             "--n_fft", "128", "--hop_length", "64", "--win_length", "128", "--bins", "128",
             "--export_batch", "2", "--checkpoints_dir", str(tmp_path / "out"),
             "--load_pretrain", str(tmp_path / "pre")]
    opt = TrainOptions().parse(flags, save=False)
    gen = build_generator(opt)
    state = state_dict_from_jax(*random_jax_trees(gen, rng))
    (tmp_path / "pre").mkdir()
    torch.save(export_to_torch_keys(state, generator_entries_for(gen)),
               tmp_path / "pre" / "latest_net_G.pth")
    return flags, opt, state


@pytest.mark.cuda
def test_small_export_on_card_launches_k1_and_k2(cuda, tmp_path):
    """``export_cli`` on the card at small geometry, loaded by
    ``serve_export.load``: one K1 and one K2 launch a call, the FFT forms,
    through the registered operators, and the SR within 2e-3 of its largest
    value of the port's inference on the CPU from the same ``.pth``."""
    from mdctgan_tpu_torch import export_cli, serve_export

    rng = np.random.default_rng(4)
    flags, opt, state = _small_pth(tmp_path, rng)
    gen = build_generator(opt)
    written = export_cli.main(flags + ["--export_path", str(tmp_path / "m.pt2")])
    assert written["device"] == "cuda:0"
    serve = serve_export.load(written["path"])
    x = torch.from_numpy((0.05 * rng.standard_normal((2, 8128))).astype(np.float32))
    K.reset_launch_counts()
    got = serve(x.to(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"mdct_spectro": 1, "imdct_audio": 1,
                          "mdct_spectro_dense": 0, "imdct_audio_dense": 0}
    gen.load_state_dict(state, strict=True)
    _, ref = build_inference_fn(gen.eval(), SpectralTransform(spectral_config_from_opt(opt), "cpu"),
                                out_length=8128)(x)
    scale = float(ref.abs().max())
    assert float((got.cpu() - ref).abs().max()) <= 2e-3 * scale


@pytest.mark.cuda
def test_small_multi_platform_export_serves_on_card_and_cpu(cuda, tmp_path):
    """``--export_platforms tpu,cpu`` exported on the card: one file whose
    state lies on the CPU; ``load`` places it on the card by default (one K1
    and one K2 launch a call) and on the CPU when asked (no launch), each
    against ``model.inference`` on its device within 2e-3 of its largest
    value; no node of the CPU program names the card."""
    from mdctgan_tpu_torch import export_cli, serve_export

    rng = np.random.default_rng(5)
    flags, opt, state = _small_pth(tmp_path, rng)
    written = export_cli.main(flags + ["--export_platforms", "tpu,cpu",
                                       "--export_path", str(tmp_path / "m.pt2")])
    assert written["device"] == "cuda:0" and written["platforms"] == ["tpu", "cpu"]
    assert {t.device.type for t in torch.export.load(written["path"]).state_dict.values()} \
        == {"cpu"}
    x = torch.from_numpy((0.05 * rng.standard_normal((2, 8128))).astype(np.float32))
    for device, launches in ((None, 1), ("cpu", 0)):
        serve = serve_export.load(written["path"], device=device)
        on = cuda if device is None else torch.device("cpu")
        K.reset_launch_counts()
        got = serve(x.to(on))
        if on.type == "cuda":
            torch.cuda.synchronize()
        assert got.device.type == on.type
        assert K.LAUNCHES == {"mdct_spectro": launches, "imdct_audio": launches,
                              "mdct_spectro_dense": 0, "imdct_audio_dense": 0}
        with torch.inference_mode():
            ref = api.create_model(opt, on, state_dict=state).inference(x.to(on))[1]
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 2e-3 * scale
    named = [n.name for n in torch.export.load(written["path"]).graph.nodes
             if "cuda" in str((n.args, n.kwargs, getattr(n.meta.get("val"), "device", "")))]
    assert not named, named


@pytest.mark.cuda
def test_flagship_f32_generator_runs_slices_of_8_on_card(cuda, monkeypatch):
    """The flagship-width float32 generator at batch 16 (``generate_audio.sh``'s
    batch) runs every convolution on the card in slices of 8 rows, and
    agrees with the whole-batch path it ran before within the port's
    generator bound, 5e-4; the slices with TF32 on do not."""
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models import layers
    from mdctgan_tpu_torch.weights import init_weights

    gen = build_generator(flagship_opt())
    init_weights(gen, torch.Generator().manual_seed(0))
    gen = gen.to(cuda).eval()
    x = torch.randn(16, 2, 128, 256, generator=torch.Generator().manual_seed(1)).to(cuda)
    rows, conv2d = [], torch.nn.functional.conv2d

    def counted(t, *args, **kw):
        rows.append(t.shape[0])
        return conv2d(t, *args, **kw)

    with torch.no_grad():
        monkeypatch.setattr(torch.nn.functional, "conv2d", counted)
        with float32_policy():
            got = gen(x)
        monkeypatch.setattr(torch.nn.functional, "conv2d", conv2d)
        convs = sum(isinstance(m, torch.nn.Conv2d) for m in gen.modules())
        assert rows == [8] * (2 * convs)
        with float32_policy(allow_tf32=True):
            tf32 = gen(x)
        monkeypatch.setattr(layers, "f32_conv_rows", lambda *a: None)
        with float32_policy():
            whole = gen(x)
    assert float((got - whole).abs().max()) <= 5e-4
    assert float((tf32 - whole).abs().max()) > 5e-4
