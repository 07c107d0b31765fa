"""The port's serving slice as a whole against the JAX reference
(``build_inference_fn`` and ``api.upsample`` at small geometry), its
resampling and segmentation, and the guards that keep the port free of JAX
and off any silent CPU path."""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdctgan_tpu import api as japi
from mdctgan_tpu.data.dataset import AudioAppDataset as JAudioAppDataset
from mdctgan_tpu.models.generator import LocalEnhancer as JLocalEnhancer
from mdctgan_tpu.ops import resample as jres
from mdctgan_tpu.ops.features import SpectralConfig as JSpectralConfig
from mdctgan_tpu.ops.features import SpectralTransform as JSpectralTransform
from mdctgan_tpu.train.step import build_inference_fn as j_build_inference_fn

from mdctgan_tpu_torch import api as tapi
from mdctgan_tpu_torch.data.dataset import AudioAppDataset
from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.models.generator import LocalEnhancer
from mdctgan_tpu_torch.ops import resample as tres
from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform
from mdctgan_tpu_torch.train.step import build_inference_fn
from mdctgan_tpu_torch.weights import state_dict_from_jax

from test_torch_models import _flax_vars

ROOT = Path(__file__).resolve().parents[1]
SPECTRAL = dict(n_fft=128, hop_length=64, win_length=128, segment_length=8128)
GEN = dict(
    input_nc=2, output_nc=1, ngf=4, n_downsample_global=2, n_blocks_global=1,
    n_blocks_local=1, n_attn_global=1, input_size=(128, 64), heads_g=2,
    dim_head_g=4, downsample_type="resconv", upsample_type="interpolate",
)
OPT = dict(
    SPECTRAL, bins=128, netG="local", ngf=4, n_downsample_global=2,
    n_blocks_global=1, n_blocks_local=1, n_blocks_attn_g=1, heads_g=2,
    dim_head_g=4, downsample_type="resconv", upsample_type="interpolate",
)


def _weights(rng):
    flax_g = JLocalEnhancer(**GEN)
    params, stats = _flax_vars(flax_g, np.zeros((1, 2, 128, 64), np.float32), rng,
                               train=False)
    return flax_g, {"params": params, "batch_stats": stats}, state_dict_from_jax(params, stats)


def _clip(rng, n, rate):
    t = np.arange(n) / rate
    x = sum(0.1 / k * np.sin(2 * np.pi * 220 * k * t) for k in range(1, 6))
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_build_inference_fn_matches_jax(rng):
    flax_g, g_vars, sd = _weights(rng)
    seg = SPECTRAL["segment_length"]
    lr = (0.1 * rng.standard_normal((3, seg))).astype(np.float32)
    j_infer = j_build_inference_fn(
        flax_g, JSpectralTransform(JSpectralConfig(**SPECTRAL), use_fused=False),
        out_length=seg)
    ref_sr, ref_audio = (np.asarray(a) for a in j_infer(g_vars, jnp.asarray(lr)))

    gen = LocalEnhancer(**GEN)
    gen.load_state_dict(sd, strict=True)
    infer = build_inference_fn(gen.eval(), SpectralTransform(SpectralConfig(**SPECTRAL), "cpu"),
                               out_length=seg)
    sr, audio = infer(torch.from_numpy(lr))
    assert sr.shape == ref_sr.shape and audio.shape == ref_audio.shape == (3, seg)
    np.testing.assert_allclose(sr.numpy(), ref_sr, atol=1.2e-3)
    scale = float(np.abs(ref_audio).max())
    np.testing.assert_allclose(audio.numpy(), ref_audio, atol=2e-3 * scale)


@pytest.mark.parametrize("rate,is_lr_input", [(48000, False), (16000, True)])
def test_api_upsample_matches_jax(rng, rate, is_lr_input):
    """A 1.3-segment clip with overlapping segments, through the whole API:
    resample, segment, batch (the last batch zero-padded), stitch, crop."""
    flax_g, g_vars, sd = _weights(rng)
    seg = SPECTRAL["segment_length"]
    cfg = JSpectralConfig(**SPECTRAL)
    jt = JSpectralTransform(cfg, use_fused=False)
    j_model = japi.Model(flax_g, None, jt, None, None,
                         j_build_inference_fn(flax_g, jt, out_length=seg))
    n = int(1.3 * seg * rate / cfg.hr_sampling_rate)
    clip = _clip(rng, n, rate)
    ref = japi.upsample(clip, rate, g_vars, j_model, is_lr_input=is_lr_input,
                        gen_overlap=256, batch_size=2)

    model = tapi.create_model(OPT, device="cpu", state_dict=sd)
    got = tapi.upsample(clip, rate, model, is_lr_input=is_lr_input,
                        gen_overlap=256, batch_size=2)
    assert got.shape == ref.shape == (int(round(n * 48000 / rate)),)
    np.testing.assert_allclose(got, ref, atol=2e-3 * float(np.abs(ref).max()))


# n_fft 480 / hop 240: a 10 ms hop at 24 kHz, not a power of two (the
# card's dense K1/K2); 127 hops a segment give the generator 128 frames
SPECTRAL_480 = dict(n_fft=480, hop_length=240, win_length=480, segment_length=127 * 240)
GEN_480 = dict(GEN, ngf=8, dim_head_g=8, input_size=(128, 240))
OPT_480 = dict(OPT, **SPECTRAL_480, ngf=8, dim_head_g=8)


def test_api_upsample_at_n480_matches_jax_pallas(rng):
    """The serving chain at n_fft 480 (narrow width: ngf 8, 2 heads of 8),
    through the whole API, against the JAX package with its Pallas kernels
    in interpret mode (``use_fused=True, fused_interpret=True``), on the
    same weights (``state_dict_from_jax``): the waveform within 2e-3 of its
    largest value, the bound of ``test_api_upsample_matches_jax``."""
    flax_g = JLocalEnhancer(**GEN_480)
    params, stats = _flax_vars(flax_g, np.zeros((1, 2, 128, 240), np.float32), rng,
                               train=False)
    g_vars = {"params": params, "batch_stats": stats}
    seg = SPECTRAL_480["segment_length"]
    jt = JSpectralTransform(JSpectralConfig(**SPECTRAL_480), use_fused=True,
                            fused_interpret=True)
    assert jt.use_fused
    j_model = japi.Model(flax_g, None, jt, None, None,
                         j_build_inference_fn(flax_g, jt, out_length=seg))
    n = int(1.3 * seg * 16000 / 48000)
    clip = _clip(rng, n, 16000)
    ref = japi.upsample(clip, 16000, g_vars, j_model, is_lr_input=True, gen_overlap=256,
                        batch_size=2)

    model = tapi.create_model(OPT_480, device="cpu", state_dict=state_dict_from_jax(params, stats))
    assert model.transform.fused
    got = tapi.upsample(clip, 16000, model, is_lr_input=True, gen_overlap=256, batch_size=2)
    assert got.shape == ref.shape == (n * 3,)
    np.testing.assert_allclose(got, ref, atol=2e-3 * float(np.abs(ref).max()))


@pytest.mark.parametrize("orig,new", [(16000, 48000), (48000, 16000), (44100, 48000)])
def test_resample_matches_jax(rng, orig, new):
    k, w = tres.sinc_resample_kernel(orig, new)
    jk, jw = jres.sinc_resample_kernel(orig, new)
    assert w == jw
    np.testing.assert_array_equal(k, jk)
    x = rng.standard_normal((2, 3001)).astype(np.float32)
    ref = np.asarray(jres.resample(jnp.asarray(x), orig, new))
    got = tres.resample(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_degrade_lr_matches_jax(rng):
    x = rng.standard_normal((1, 4800)).astype(np.float32)
    ref = np.asarray(jres.degrade_lr(jnp.asarray(x), 48000, 16000, 48000))
    got = tres.degrade_lr(torch.from_numpy(x), 48000, 16000, 48000).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("length,overlap", [(20000, 512), (20000, 0), (5000, 512)])
def test_segments_and_stitch_match_jax(rng, length, overlap):
    audio = rng.standard_normal(length).astype(np.float32)
    ours = AudioAppDataset(audio, 48000, 8128, overlap)
    ref = JAudioAppDataset(audio, 48000, 8128, overlap)
    segs, ref_segs = ours.segments_of(audio), ref.segments_of(audio)
    np.testing.assert_array_equal(segs, ref_segs)
    gen = rng.standard_normal(segs.shape).astype(np.float32)
    np.testing.assert_array_equal(ours.stitch(gen), ref.stitch(gen))


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------

_BANNED = ("jax", "flax", "optax", "orbax", "mdctgan_tpu")


def _banned(module: str) -> bool:
    return module.split(".")[0] in _BANNED


def test_port_imports_no_jax():
    files = (sorted((ROOT / "mdctgan_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "probes").glob("*.py")))
    assert len(files) > 10
    # the train entry point and every module it added; the serving export
    # and the FLAC encoder; the checkpoint verifier and the dry run
    for name in ("train_cli.py", "export_torch_cli.py", "data/pipeline.py", "train/checkpoint.py",
                 "utils/visualizer.py", "utils/html.py", "utils/spectro_img.py",
                 "utils/profiling.py", "export_cli.py", "serve_export.py", "data/flacenc.py",
                 "verify_import_cli.py", "dryrun.py"):
        assert ROOT / "mdctgan_tpu_torch" / name in files, name
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad = [n for n in names if _banned(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_create_model_leaves_jax_unimported():
    code = (
        "import sys\n"
        "from mdctgan_tpu_torch.api import create_model\n"
        f"create_model({OPT!r}, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_BANNED!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_train_step_leaves_jax_unimported():
    """A train state built and one step taken on the CPU, in a fresh
    interpreter: still no JAX, Flax, optax or reference module."""
    code = (
        "import sys, numpy as np, torch\n"
        "from mdctgan_tpu_torch.models.discriminator import build_discriminator\n"
        "from mdctgan_tpu_torch.models.generator import build_generator\n"
        "from mdctgan_tpu_torch.ops.features import SpectralTransform\n"
        "from mdctgan_tpu_torch.options import spectral_config_from_opt\n"
        "from mdctgan_tpu_torch.train.schedule import make_optimizers\n"
        "from mdctgan_tpu_torch.train.state import create_train_state\n"
        "from mdctgan_tpu_torch.train.step import build_train_step\n"
        f"opt = dict({OPT!r}, ndf=4, n_layers_D=2, num_D=2)\n"
        "g_tx, d_tx = make_optimizers(2e-4, 0.5, 1, 1, 10)\n"
        "state = create_train_state(build_generator(opt), build_discriminator(opt), g_tx,\n"
        "                           d_tx, device='cpu', rng=torch.Generator().manual_seed(0))\n"
        "step = build_train_step(SpectralTransform(spectral_config_from_opt(opt), 'cpu'), g_tx, d_tx,\n"
        "                        n_layers_d=2, num_d=2)\n"
        "x = torch.from_numpy(0.1 * np.random.default_rng(0).standard_normal((2, 8128)))\n"
        "state, m = step(state, {'lr_audio': x.float(), 'hr_audio': x.float()})\n"
        "assert state.step == 1 and all(bool(torch.isfinite(v)) for v in m.values())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_BANNED!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_create_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.create_model(OPT)


def test_spectral_transform_without_cuda_raises(monkeypatch):
    """The transform a caller hands to ``build_train_step`` is an entry
    point too: its default is the card, never a silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpectralTransform(SpectralConfig(**SPECTRAL))
    assert SpectralTransform(SpectralConfig(**SPECTRAL), "cpu").spectro_mat.device.type == "cpu"


@pytest.mark.parametrize("caller_allows_tf32", [True, False])
def test_float32_policy_is_scoped_to_the_port(rng, caller_allows_tf32):
    """The port runs its products in full float32 but leaves the caller's
    TF32 switches as it found them: ``create_model`` and ``upsample``
    change nothing for other code in the process."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = caller_allows_tf32
        with float32_policy():
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, False)
        with float32_policy(allow_tf32=True):
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
        seen = []
        model = tapi.create_model(OPT, device="cpu")
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (caller_allows_tf32,) * 2
        model.generator.register_forward_hook(
            lambda *_: seen.append((matmul.allow_tf32, cudnn.allow_tf32)))
        tapi.upsample(_clip(rng, 4000, 16000), 16000, model, is_lr_input=True)
        assert seen == [(False, False)]
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (caller_allows_tf32,) * 2
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
