"""The port's generate slice against the JAX package on the CPU: the
transposed-conv upsample and the ``netG global`` default, the options, file
I/O, the noise, the metrics, the ``.pth`` importer with its fallback ladder,
the shared segment loop, and the generate CLI as a whole in single-file and
batch mode on the same ``.pth`` and WAVs, in float32 and with ``--fp16``.

Sizes: the geometry of ``tests/test_cli.py``'s generate smoke test (n_fft
128, 8128-sample segments, ``netG global`` ngf 4 with 2 downsamples, one
resblock and one attention block, conv down, transconv up).  Each JAX CLI
run happens once per module (fixtures).
"""

import csv
import os
import sys
import wave
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdctgan_tpu import generate_cli as jcli
from mdctgan_tpu.data import dataset as jds
from mdctgan_tpu.data import native as jnative
from mdctgan_tpu.models import generator as jgen
from mdctgan_tpu.models import layers as jlayers
from mdctgan_tpu.models.discriminator import MultiscaleDiscriminator as JMultiscaleDiscriminator
from mdctgan_tpu.models.generator import build_generator as j_build_generator
from mdctgan_tpu.ops import metrics as jmetrics
from mdctgan_tpu.ops import resample as jres
from mdctgan_tpu.ops.features import SpectralTransform as JSpectralTransform
from mdctgan_tpu.options import TestOptions as JTestOptions
from mdctgan_tpu.options import TrainOptions as JTrainOptions
from mdctgan_tpu.options import spectral_config_from_opt as j_spectral_config_from_opt
from mdctgan_tpu.train import import_torch as jimp
from mdctgan_tpu.train.step import build_inference_fn as j_build_inference_fn

from mdctgan_tpu_torch import api, generate_cli, options
from mdctgan_tpu_torch.configs import flagship_opt
from mdctgan_tpu_torch.data import dataset as tds
from mdctgan_tpu_torch.data import native as tnative
from mdctgan_tpu_torch.models import generator as tgen
from mdctgan_tpu_torch.models import layers as tlayers
from mdctgan_tpu_torch.models.discriminator import MultiscaleDiscriminator
from mdctgan_tpu_torch.ops import metrics as tmetrics
from mdctgan_tpu_torch.ops import resample as tres
from mdctgan_tpu_torch.train import import_torch as timp
from mdctgan_tpu_torch.train.restore import load_generator_state
from mdctgan_tpu_torch.weights import init_weights, state_dict_from_jax

from test_import_gold import (
    FLAGSHIP_LOCAL,
    SMALL_GLOBAL as GOLD_GLOBAL,
    SMALL_LOCAL_ATTN_ONLY,
    SMALL_LOCAL_BOTH_ATTN,
    SMALL_LOCAL_N2,
    _flax_global,
    _flax_local,
    _randomize,
    _torch_global,
)
from test_torch_models import SMALL_GLOBAL, _flax_vars, _parity, port_local_kwargs

FLAGS = [
    "--lr_sampling_rate", "16000", "--center", "--arcsinh_transform",
    "--abs_spectro", "--abs_norm", "--norm_range", "-1", "1",
    "--fit_residual", "--netG", "global", "--ngf", "4",
    "--n_downsample_global", "2", "--n_blocks_global", "1",
    "--n_blocks_attn_g", "1", "--heads_g", "2", "--dim_head_g", "4",
    "--segment_length", "8128", "--n_fft", "128", "--hop_length", "64",
    "--win_length", "128", "--bins", "128", "--batchSize", "2",
    "--gpu_ids", "-1", "--jax_cache_dir", "",
]
SECONDS = (14000, 20000, 900)  # 48 kHz samples: 2, 3 and 1 segments; the
# last is shorter than one 30 ms frame, so its segmental SNR is NaN
METRICS = ("mse", "snr_sr", "snr_lr", "snr_seg", "lsd")


def _jax_opt(tmp, extra=()):
    return JTrainOptions().parse(FLAGS + ["--checkpoints_dir", str(tmp)] + list(extra),
                                 save=False)


def _assert_metrics_close(got, ref):
    """LSD 1e-3 relative, each SNR 0.01 dB, MSE 1e-2 relative; NaN only
    where the reference is NaN."""
    for k in METRICS:
        g, r = float(got[k]), float(ref[k])
        if np.isnan(r):
            assert np.isnan(g), k
        elif k.startswith("snr"):
            assert abs(g - r) <= 0.01, (k, g, r)
        else:
            assert abs(g - r) <= {"lsd": 1e-3, "mse": 1e-2}[k] * abs(r), (k, g, r)


def _read_wav(path):
    with wave.open(str(path)) as w:
        rate, n = w.getframerate(), w.getnframes()
        data = np.frombuffer(w.readframes(n), "<i2").astype(np.float32) / 32768.0
    return rate, data


# --------------------------------------------------------------------------
# the shared corpus, weights and each JAX run once
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("generate")
    opt = _jax_opt(root / "unused")
    flax_g = j_build_generator(opt)
    rng = np.random.default_rng(5)
    params, stats = _flax_vars(flax_g, np.zeros((1, 2, 128, 64), np.float32), rng,
                               train=False)
    # a damped head keeps the SR band small, as a trained model's is, so the
    # 16-bit WAVs hold the output unclipped
    params["head"]["conv"] = {k: v * 0.01 for k, v in params["head"]["conv"].items()}
    pretrain = root / "pretrained"
    pretrain.mkdir()
    ref_sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in
              jimp.export_to_torch_keys(params, stats,
                                        jimp.generator_entries_for(flax_g)).items()}
    torch.save(ref_sd, pretrain / "latest_net_G.pth")
    wavs = root / "wavs"
    wavs.mkdir()
    t = np.arange(max(SECONDS)) / 48000
    for i, n in enumerate(SECONDS):
        x = sum(0.1 / k * np.sin(2 * np.pi * 180 * k * t[:n] + i) for k in range(1, 8))
        x = (x + 0.01 * rng.standard_normal(n) + 0.02).astype(np.float32)
        tnative.write_wav16(str(wavs / f"s{i}.wav"), x, 48000)
    (root / "list.csv").write_text("wavs/s0.wav\nwavs/s1.wav\nwavs/s2.wav\nwavs/missing.wav\n")
    return dict(root=root, pretrain=pretrain, wavs=wavs, csv=root / "list.csv",
                flax_g=flax_g, params=params, stats=stats, ref_sd=ref_sd)


def _cli_args(corpus, out, name, dataroot):
    return FLAGS + ["--checkpoints_dir", str(out), "--name", name,
                    "--dataroot", str(dataroot), "--load_pretrain", str(corpus["pretrain"])]


@pytest.fixture(scope="module")
def jax_runs(corpus):
    out = corpus["root"] / "jax"
    for name, dataroot in (("batch", corpus["csv"]), ("single", corpus["wavs"] / "s1.wav")):
        with mock.patch.object(sys, "argv", ["generate_audio.py"]
                               + _cli_args(corpus, out, name, dataroot)):
            jcli.main()
    return out


@pytest.fixture(scope="module")
def port_runs(corpus):
    out = corpus["root"] / "port"
    results = {name: generate_cli.main(_cli_args(corpus, out, name, dataroot))
               for name, dataroot in (("batch", corpus["csv"]),
                                      ("single", corpus["wavs"] / "s1.wav"))}
    return out, results


# --------------------------------------------------------------------------
# ConvTransposed and the transconv generators
# --------------------------------------------------------------------------

def test_conv_transposed_matches_flax(rng):
    x = rng.standard_normal((2, 8, 5, 7)).astype(np.float32)
    _parity(jlayers.ConvTransposed(4), tlayers.ConvTransposed(8, 4), x, rng, atol=1e-4)


@pytest.mark.parametrize("include_head", [True, False])
def test_transconv_global_generator_matches_flax(rng, include_head):
    cfg = dict(SMALL_GLOBAL, upsample_type="transconv", include_head=include_head)
    x = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    _parity(jgen.GlobalGenerator(**cfg), tgen.GlobalGenerator(**cfg), x, rng,
            atol=5e-4, train=False)


def test_transconv_global_generator_matches_reference_torch(rng):
    """The reference's own construction (the stock-torch replica of
    ``test_import_gold.py``, conv down, transconv up, attention, head) saved
    as a state_dict: the port imports it strictly and its forward equals the
    replica's, so the transposed kernel carries with no spatial flip."""
    cfg = GOLD_GLOBAL
    ref = _torch_global(cfg)
    _randomize(ref, rng)
    port = tgen.GlobalGenerator(
        input_nc=cfg["input_nc"], output_nc=cfg["output_nc"], ngf=cfg["ngf"],
        n_downsampling=cfg["n_downsampling"], n_blocks=cfg["n_blocks"],
        n_attn=cfg["n_attn_g"], input_size=cfg["input_size"],
        proj_factor=cfg["proj_factor"], heads=cfg["heads"], dim_head=cfg["dim_head"],
        downsample_type=cfg["downsample_type"], upsample_type=cfg["upsample_type"])
    state, rungs = timp.import_generator(ref.state_dict(), port)
    assert rungs == []
    port.load_state_dict(state, strict=True)
    x = torch.from_numpy(rng.standard_normal((2, 2, *cfg["input_size"])).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(port.eval()(x).numpy(), ref.eval()(x).numpy(), atol=5e-4)


def test_netg_global_default_builds_and_matches_jax_shapes():
    """The JAX package's default generator (``netG global``, transconv up)
    from a parsed namespace: the same parameters, of the same shapes."""
    opt = options.defaults()
    port = tgen.build_generator(opt)
    flax_g = j_build_generator(opt)
    shapes = jax.eval_shape(lambda: flax_g.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 128, 256, 2)), train=False))
    ref = state_dict_from_jax(*(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                       shapes[k])
                                for k in ("params", "batch_stats")))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert isinstance(port.up0, tlayers.ConvTransposed)


@pytest.mark.parametrize("form", ["dict", "namespace"])
def test_build_generator_reads_dict_and_namespace(form):
    """Both forms give the module JAX's ``build_generator`` gives, with the
    dict defaults as JAX has them (3 downsamples; the CLI's default is 4)."""
    if form == "dict":
        opt = dict(netG="global", ngf=4, n_blocks_global=2)
    else:
        opt = options.defaults()
        opt.ngf, opt.n_blocks_global = 4, 2
    port, flax_g = tgen.build_generator(opt), j_build_generator(opt)
    assert (port.n_downsampling, port.n_blocks, port.n_attn, port.upsample_type) == \
        (flax_g.n_downsampling, flax_g.n_blocks, flax_g.n_attn, flax_g.upsample_type)
    assert port.n_downsampling == (3 if form == "dict" else 4)


# --------------------------------------------------------------------------
# options
# --------------------------------------------------------------------------

def test_options_write_the_same_opt_txt(tmp_path):
    args = FLAGS + ["--name", "o", "--param_key_map", "model.1:2"]
    j = JTrainOptions().parse(args + ["--checkpoints_dir", str(tmp_path / "j")], save=True)
    t = options.TrainOptions().parse(args + ["--checkpoints_dir", str(tmp_path / "t")],
                                     save=True)
    assert t.gpu_ids == j.gpu_ids == [] and t.param_key_map == {"model.1": "2"}
    text = {k: (tmp_path / k / "o" / "opt.txt").read_text().replace(str(tmp_path / k), "D")
            for k in ("j", "t")}
    assert text["t"] == text["j"]
    j_test = JTestOptions()
    j_test.initialize()
    assert vars(options.defaults(options.TestOptions)) == vars(j_test.parser.parse_args([]))


def test_train_defaults_are_the_flags_defaults():
    j_train = JTrainOptions()
    j_train.initialize()
    d = vars(j_train.parser.parse_args([]))
    assert options.TRAIN_DEFAULTS == {k: d[k] for k in options.TRAIN_DEFAULTS}


def test_tpu_form_flags_are_ignored(tmp_path, monkeypatch):
    opt = options.TrainOptions().parse(
        FLAGS + ["--checkpoints_dir", str(tmp_path), "--upsample_method", "dense",
                 "--head_phases", "16", "--dilated_vjp", "gx", "--matmul_precision",
                 "highest"], save=False)
    assert opt.upsample_method == "dense"
    assert not [k for k in os.environ if k.startswith("MDCTGAN_")]
    assert options.serving_devices(opt) == [torch.device("cpu")]


def test_serving_device_rules(monkeypatch):
    """``-1`` is the CPU; ids name cards, and an id this host has no card
    for raises (the JAX CLIs clamp the count silently)."""
    assert options.serving_devices({"gpu_ids": []}) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="fused_mdct"):
        options.serving_devices({"gpu_ids": [], "fused_mdct": "off"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert options.serving_devices({"gpu_ids": [1, 0]}) == [torch.device("cuda:1"),
                                                            torch.device("cuda:0")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 CUDA device"):
        options.serving_devices({"gpu_ids": [0, 1]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ids in ([0], [0, 1]):
        with pytest.raises(RuntimeError, match="CUDA"):
            options.serving_devices({"gpu_ids": ids})


def test_spectral_config_from_namespace_and_dict():
    ns = options.defaults()
    for k, v in (("center", True), ("arcsinh_transform", True), ("abs_norm", True),
                 ("norm_range", [-1.0, 1.0]), ("n_fft", 128), ("hop_length", 64),
                 ("win_length", 128), ("segment_length", 8128)):
        setattr(ns, k, v)
    got = options.spectral_config_from_opt(ns)
    assert got == options.spectral_config_from_opt(vars(ns))
    ref = j_spectral_config_from_opt(ns)
    for field in ("n_fft", "hop_length", "win_length", "center", "segment_length",
                  "arcsinh_gain", "norm_range", "src_range", "abs_norm", "fit_residual"):
        assert getattr(got, field) == getattr(ref, field), field


# --------------------------------------------------------------------------
# file I/O
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["dir", "csv"])
def test_list_audio_files_matches_jax(tmp_path, form):
    for rel in ("b/x.wav", "a.flac", "b/c/y.WAV", "notes.txt", "z.aiff"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    path = tmp_path
    if form == "csv":
        path = tmp_path / "list.csv"
        path.write_text("a.flac,b/x.wav\n\nz.aiff\n")
    assert tds.list_audio_files(str(path)) == jds.list_audio_files(str(path))
    assert tds.supported_exts() == jds.supported_exts()
    assert tds.unsupported_note(["a.mp3", "b.xyz"]) == jds.unsupported_note(["a.mp3", "b.xyz"])


def test_audio_test_dataset_matches_jax(corpus):
    for name in ("s0.wav", "s2.wav"):
        path = str(corpus["wavs"] / name)
        ours, ref = tds.AudioTestDataset(path, 8128, 256), jds.AudioTestDataset(path, 8128, 256)
        np.testing.assert_array_equal(ours.raw_audio, ref.raw_audio)
        assert abs(float(ours.raw_audio.mean()) - 1e-4) < 1e-6  # the DC shift
        assert (ours.in_sampling_rate, ours.audio_len) == (ref.in_sampling_rate, ref.audio_len)
        np.testing.assert_array_equal(ours.segments_of(ours.raw_audio),
                                      ref.segments_of(ref.raw_audio))
    assert tnative.info(path) == jnative.info(path)


def test_write_wav16_writes_jax_bytes(tmp_path, rng):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 3000), [0.5 / 32768, -1.0, 1.0]])
    tnative.write_wav16(str(tmp_path / "t.wav"), x, 48000)
    jnative.write_wav16(str(tmp_path / "j.wav"), x, 48000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    np.testing.assert_array_equal(tnative.read(str(tmp_path / "t.wav"))[0],
                                  jnative.read(str(tmp_path / "j.wav"))[0])
    # the stdlib reader, where the library is not there
    np.testing.assert_array_equal(tnative._py_read(str(tmp_path / "t.wav"), 10, 50)[0],
                                  jnative._py_read(str(tmp_path / "j.wav"), 10, 50)[0])


# --------------------------------------------------------------------------
# noise and length
# --------------------------------------------------------------------------

def test_noise_scaling_matches_jax(rng):
    x = (0.2 * rng.standard_normal((3, 5000))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jres.add_noise_snr(jnp.asarray(x), key, 30.0, 8128))
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = tres.scale_noise_to_snr(torch.from_numpy(x), torch.from_numpy(noise), 30.0, 8128)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_add_noise_snr_is_seeded():
    x = torch.full((2, 4000), 0.1)
    a = tres.add_noise_snr(x, 20.0, 8128, torch.Generator().manual_seed(1))
    b = tres.add_noise_snr(x, 20.0, 8128, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, x)
    snr = 10 * torch.log10(x.square().sum(-1) / 8128 / (a - x).var(-1, correction=0))
    np.testing.assert_allclose(snr.numpy(), 20.0, atol=1e-3)


@pytest.mark.parametrize("length", [100, 5000, 5001, 7000])
def test_fix_length_matches_jax(rng, length):
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    ref = np.asarray(jres.fix_length(jnp.asarray(x), length))
    got = tres.fix_length(torch.from_numpy(x), length).numpy()
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mse", "snr_db", "snr_seg", "snr_seg_short", "stft_power",
                                  "lsd", "compute_metrics", "nanmean_rows"])
def test_metric_matches_jax(rng, name):
    hr = (0.1 * rng.standard_normal((1, 20000))).astype(np.float32)
    sr = (hr + 0.01 * rng.standard_normal(hr.shape)).astype(np.float32)
    lr = (hr + 0.05 * rng.standard_normal(hr.shape)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in (("hr", hr), ("sr", sr), ("lr", lr))}
    j = {k: jnp.asarray(v) for k, v in (("hr", hr), ("sr", sr), ("lr", lr))}
    if name == "nanmean_rows":
        rows = [{"a": 1.0, "b": float("nan")}, {"a": 3.0, "b": float("nan")},
                {"a": float("nan"), "b": float("nan")}]
        assert tmetrics.nanmean_rows(rows).keys() == jmetrics.nanmean_rows(rows).keys()
        got, ref = tmetrics.nanmean_rows(rows), jmetrics.nanmean_rows(rows)
        assert got["a"] == ref["a"] == 2.0 and np.isnan(got["b"]) and np.isnan(ref["b"])
        return
    if name == "compute_metrics":
        got = tmetrics.compute_metrics(t["hr"], t["lr"], t["sr"], 128, 64, 128)
        ref = jmetrics.compute_metrics(j["hr"], j["lr"], j["sr"], 128, 64, 128)
        assert list(got) == list(ref) == list(METRICS)
        for k in METRICS:
            tol = dict(atol=1e-4, rtol=0) if k.startswith("snr") else dict(rtol=1e-5)
            np.testing.assert_allclose(float(got[k]), float(ref[k]), **tol)
        return
    if name == "snr_seg_short":  # below one 30 ms frame: NaN on both sides
        got = tmetrics.snr_seg(t["hr"][:, :1000], t["sr"][:, :1000], 48000)
        ref = jmetrics.snr_seg(j["hr"][:, :1000], j["sr"][:, :1000], 48000)
        assert np.isnan(float(got)) and np.isnan(float(ref))
        return
    if name == "stft_power":
        w = tmetrics.kbd_window(256)
        got = tmetrics.stft_power(t["hr"], 256, 128, 256, w).numpy()
        ref = np.asarray(jmetrics.stft_power(j["hr"], 256, 128, 256, w))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))
        return
    args = {"mse": ("hr", "sr"), "snr_db": ("hr", "lr"), "snr_seg": ("hr", "sr"),
            "lsd": ("hr", "sr")}[name]
    extra = (48000,) if name == "snr_seg" else ()
    got = float(getattr(tmetrics, name)(*(t[a] for a in args), *extra))
    ref = float(getattr(jmetrics, name)(*(j[a] for a in args), *extra))
    tol = dict(atol=1e-4, rtol=0) if name.startswith("snr") else dict(rtol=1e-5)
    np.testing.assert_allclose(got, ref, **tol)


# --------------------------------------------------------------------------
# the .pth importer
# --------------------------------------------------------------------------

_KEYSET_CASES = {
    "flagship_local": (FLAGSHIP_LOCAL, "local"),
    "small_local_both_attn": (SMALL_LOCAL_BOTH_ATTN, "local"),
    "small_local_n2": (SMALL_LOCAL_N2, "local"),
    "small_local_attn_only": (SMALL_LOCAL_ATTN_ONLY, "local"),
    "small_global": (GOLD_GLOBAL, "global"),
}


@pytest.mark.parametrize("case", sorted(_KEYSET_CASES))
def test_tables_and_expected_keys_match_jax(case):
    """Every branch the JAX importer maps, local attention and two enhancer
    branches included (the port's generators of those layouts load them:
    ``test_import_generator_matches_jax``)."""
    cfg, kind = _KEYSET_CASES[case]
    if kind == "local":
        flax_g = _flax_local(cfg)
        ours = timp.local_enhancer_entries(
            cfg["n_downsample_global"], cfg["n_blocks_global"], cfg["n_attn_g"],
            cfg["n_blocks_local"], cfg["n_attn_l"], cfg["downsample_type"],
            cfg["upsample_type"], cfg.get("n_local_enhancers", 1))
    else:
        flax_g = _flax_global(cfg)
        ours = timp.global_generator_entries(
            "model", (), cfg["n_downsampling"], cfg["n_blocks"], cfg["n_attn_g"],
            cfg["downsample_type"], cfg["upsample_type"], True)
    ref = jimp.generator_entries_for(flax_g)
    assert ours == ref
    assert timp.expected_torch_keys(ours) == jimp.expected_torch_keys(ref)


@pytest.mark.parametrize("which", ["flagship", "netg_global_default", "discriminator"])
def test_port_module_tables_match_jax(which):
    if which == "discriminator":
        assert timp.discriminator_entries(3, 3) == jimp.discriminator_entries(3, 3)
        return
    opt = flagship_opt() if which == "flagship" else options.defaults()
    port, flax_g = tgen.build_generator(opt), j_build_generator(opt)
    entries = timp.generator_entries_for(port)
    assert entries == jimp.generator_entries_for(flax_g)
    req, opt_keys = timp.expected_torch_keys(entries)
    # the port's own names are the tables' Flax paths
    ported = {".".join(path) for _, path, _ in entries}
    assert ported == {k.rsplit(".", 1)[0] for k in port.state_dict()}
    assert len(req) + len(opt_keys) >= len(port.state_dict())


def _gold_global_port():
    cfg = GOLD_GLOBAL
    return tgen.GlobalGenerator(
        input_nc=cfg["input_nc"], output_nc=cfg["output_nc"], ngf=cfg["ngf"],
        n_downsampling=cfg["n_downsampling"], n_blocks=cfg["n_blocks"],
        n_attn=cfg["n_attn_g"], input_size=cfg["input_size"],
        proj_factor=cfg["proj_factor"], heads=cfg["heads"], dim_head=cfg["dim_head"],
        downsample_type=cfg["downsample_type"], upsample_type=cfg["upsample_type"])


def _gold_local_port(cfg):
    return tgen.LocalEnhancer(**port_local_kwargs(cfg))


_IMPORT_LAYOUTS = {"local_both_attn": SMALL_LOCAL_BOTH_ATTN, "local_n2": SMALL_LOCAL_N2,
                   "local_attn_only": SMALL_LOCAL_ATTN_ONLY}


@pytest.mark.parametrize("case", ["exact", "extra_keys", "param_key_map", "size_mismatch",
                                  *sorted(_IMPORT_LAYOUTS)])
def test_import_generator_matches_jax(rng, case):
    """The port's import of a reference-layout ``.pth`` equals
    ``state_dict_from_jax`` of the JAX import on the same file; a module of
    another size keeps the port's own init and the rest loads exactly.  The
    ``local_*`` cases import the local-attention and several-enhancer
    layouts exactly (the shared modules have one set of weights)."""
    layout = _IMPORT_LAYOUTS.get(case)
    flax_g = _flax_global(GOLD_GLOBAL) if layout is None else _flax_local(layout)
    size = (layout or GOLD_GLOBAL)["input_size"]
    x = np.zeros((1, 2, *size), np.float32)
    params, stats = _flax_vars(flax_g, x, rng, train=False)
    init_p, init_s = _flax_vars(flax_g, x, rng, train=False)
    entries = jimp.generator_entries_for(flax_g)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          jimp.export_to_torch_keys(params, stats, entries).items()}
    key_map, rungs_expected, kept = None, [], set()
    if case == "extra_keys":
        sd["model.99.weight"] = torch.zeros(3)
        rungs_expected = ["excess_keys"]
    elif case == "param_key_map":
        sd = {k.replace("model.1.", "model.77.", 1) if k.startswith("model.1.") else k: v
              for k, v in sd.items()}
        key_map = {"model.77": "1"}
        rungs_expected = ["param_key_map"]
    elif case == "size_mismatch":
        sd["model.1.weight"] = torch.zeros(5, 2, 7, 7)  # the stem has 4 output channels
        rungs_expected, kept = ["excess_keys", "kept_init"], {"stem.conv.weight"}
    j_params, j_stats = jimp.import_generator(
        {k: v.numpy() for k, v in sd.items()}, flax_g, param_key_map=key_map,
        init_vars={"params": init_p, "batch_stats": init_s})
    ref = state_dict_from_jax(j_params, j_stats)

    port = _gold_global_port() if layout is None else _gold_local_port(layout)
    init_weights(port, torch.Generator().manual_seed(0))
    own = {k: v.clone() for k, v in port.state_dict().items()}
    got, rungs = timp.import_generator(sd, port, param_key_map=key_map)
    assert rungs == rungs_expected
    port.load_state_dict(got, strict=True)
    assert set(got) == set(ref)
    for k in got:
        if k in kept:
            assert torch.equal(got[k], own[k]), k
            assert not torch.equal(ref[k], own[k])
        else:
            assert torch.equal(got[k], ref[k]), k


def test_export_to_torch_keys_matches_jax(rng):
    flax_g = _flax_global(GOLD_GLOBAL)
    params, stats = _flax_vars(flax_g, np.zeros((1, 2, *GOLD_GLOBAL["input_size"]),
                                                np.float32), rng, train=False)
    entries = jimp.generator_entries_for(flax_g)
    ref = jimp.export_to_torch_keys(params, stats, entries)
    got = timp.export_to_torch_keys(state_dict_from_jax(params, stats), entries)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_import_discriminator_matches_jax(rng):
    d_cfg = dict(ndf=4, n_layers=2, num_D=2)
    flax_d = JMultiscaleDiscriminator(**d_cfg)
    params, _ = _flax_vars(flax_d, np.zeros((1, 3, 32, 64), np.float32), rng)
    entries = jimp.discriminator_entries(2, 2)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          jimp.export_to_torch_keys(params, {}, entries).items()}
    disc = MultiscaleDiscriminator(3, **d_cfg)
    got, rungs = timp.import_discriminator(sd, disc, 2, 2)
    assert rungs == []
    disc.load_state_dict(got, strict=True)
    ref = state_dict_from_jax(jimp.import_discriminator(
        {k: v.numpy() for k, v in sd.items()}, 2, 2), {})
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_load_generator_state_reads_pth_and_refuses_orbax(corpus, tmp_path):
    opt = options.TrainOptions().parse(
        FLAGS + ["--checkpoints_dir", str(tmp_path), "--load_pretrain",
                 str(corpus["pretrain"])], save=False)
    gen = tgen.build_generator(opt)
    state, rungs = load_generator_state(opt, gen)
    assert rungs == []
    ref = state_dict_from_jax(corpus["params"], corpus["stats"])
    assert set(state) == set(ref) and all(torch.equal(state[k], ref[k]) for k in ref)
    (tmp_path / "only_orbax" / "ckpt").mkdir(parents=True)
    opt.load_pretrain = str(tmp_path / "only_orbax")
    with pytest.raises(SystemExit, match="net_G.pth"):
        load_generator_state(opt, gen)


# --------------------------------------------------------------------------
# the shared segment loop
# --------------------------------------------------------------------------

def test_serve_segments_same_at_any_batch_size(corpus, tmp_path):
    opt = options.TrainOptions().parse(FLAGS + ["--checkpoints_dir", str(tmp_path)],
                                       save=False)
    model = api.create_model(opt, "cpu", state_dict=state_dict_from_jax(corpus["params"],
                                                                         corpus["stats"]))
    segs = (0.1 * np.random.default_rng(2).standard_normal((5, 8128))).astype(np.float32)
    outs = {bs: api.serve_segments(model, segs, bs) for bs in (1, 2, 8)}
    assert outs[1].shape == (5, 8128) and np.isfinite(outs[1]).all()
    # the convolutions may pick another algorithm at another batch size, so
    # float32 rounding may move; the loop itself changes nothing (below)
    scale = float(np.abs(outs[1]).max())
    for bs in (2, 8):
        np.testing.assert_allclose(outs[bs], outs[1], rtol=0, atol=1e-5 * scale)
    with torch.no_grad():
        _, direct = model.inference(torch.from_numpy(segs[:2]))
    np.testing.assert_array_equal(outs[2][:2], direct.numpy())


# --------------------------------------------------------------------------
# the generate CLI as a whole
# --------------------------------------------------------------------------

def test_process_file_matches_jax(corpus, tmp_path):
    """One file through the port's ``_process_file`` and JAX's, on the
    same weights: LR to 1e-5, SR to 2e-3 of its largest value, the metrics
    at their bounds."""
    path = str(corpus["wavs"] / "s1.wav")
    jopt = _jax_opt(tmp_path)
    cfg = j_spectral_config_from_opt(jopt)
    jt = JSpectralTransform(cfg, use_fused=False)
    ref = jcli._process_file(path, jopt, cfg, jt,
                             j_build_inference_fn(corpus["flax_g"], jt, out_length=8128),
                             {"params": corpus["params"], "batch_stats": corpus["stats"]})
    opt = options.TrainOptions().parse(FLAGS + ["--checkpoints_dir", str(tmp_path)],
                                       save=False)
    model = api.create_model(opt, "cpu", state_dict=state_dict_from_jax(corpus["params"],
                                                                         corpus["stats"]))
    got = generate_cli._process_file(path, opt, options.spectral_config_from_opt(opt), model)
    sr, lr, hr, rate, m = got
    assert rate == ref[3] == 48000 and sr.shape == ref[0].shape and lr.shape == ref[1].shape
    np.testing.assert_array_equal(hr, ref[2])
    np.testing.assert_allclose(lr, ref[1], atol=1e-5)
    np.testing.assert_allclose(sr, ref[0], atol=2e-3 * float(np.abs(ref[0]).max()))
    assert list(m) == list(ref[4])
    _assert_metrics_close(m, ref[4])


def test_generate_cli_batch_matches_jax(corpus, jax_runs, port_runs):
    out, results = port_runs
    assert results["batch"]["rungs"] == []
    with open(jax_runs / "batch" / "metrics.csv") as f:
        ref_rows = list(csv.DictReader(f))
    with open(out / "batch" / "metrics.csv") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    assert reader.fieldnames == ["file", "output", *METRICS]
    assert [r["file"] for r in rows] == [r["file"] for r in ref_rows]
    assert [r["output"] for r in rows] == [r["output"] for r in ref_rows]
    assert len(rows) == 4 and rows[-1]["file"] == "MEAN"  # missing.wav skipped
    assert sorted(os.listdir(out / "batch")) == sorted(os.listdir(jax_runs / "batch"))
    for row, ref in zip(rows, ref_rows):
        _assert_metrics_close(row, ref)
        if row["file"] == "MEAN":
            continue
        rate, sr = _read_wav(out / "batch" / row["output"])
        ref_rate, ref_sr = _read_wav(jax_runs / "batch" / ref["output"])
        assert rate == ref_rate == 48000 and sr.shape == ref_sr.shape
        np.testing.assert_allclose(sr, ref_sr, atol=2e-3 * float(np.abs(ref_sr).max()))
    assert np.isnan(float(rows[2]["snr_seg"])) and not np.isnan(float(rows[-1]["snr_seg"]))


def test_generate_cli_returns_its_own_split(port_runs):
    _, results = port_runs
    batch, single = results["batch"], results["single"]
    assert list(batch["file_ms"]) == [r["file"] for r in batch["rows"]]
    assert len(single["file_ms"]) == 1
    for r in (batch, single):
        assert r["setup_ms"] > 0 and all(ms > 0 for ms in r["file_ms"].values())


def test_generate_cli_single_file_matches_jax(jax_runs, port_runs):
    out, results = port_runs
    assert results["single"]["rows"] == []
    names = {"metric.txt", "sr_audio.wav", "lr_audio.wav", "hr_audio.wav"}
    assert set(os.listdir(out / "single")) == set(os.listdir(jax_runs / "single")) == names
    lines = (out / "single" / "metric.txt").read_text().splitlines()
    ref_lines = (jax_runs / "single" / "metric.txt").read_text().splitlines()
    assert lines[0] == ref_lines[0] == "MSE,SNR_SR,LSD"
    got = dict(zip(("mse", "snr_sr", "lsd"), map(float, lines[1].split(","))))
    ref = dict(zip(("mse", "snr_sr", "lsd"), map(float, ref_lines[1].split(","))))
    _assert_metrics_close({**got, "snr_lr": 0.0, "snr_seg": 0.0},
                          {**ref, "snr_lr": 0.0, "snr_seg": 0.0})
    for name in ("sr_audio.wav", "lr_audio.wav", "hr_audio.wav"):
        rate, x = _read_wav(out / "single" / name)
        ref_rate, r = _read_wav(jax_runs / "single" / name)
        assert rate == ref_rate and x.shape == r.shape, name
        np.testing.assert_allclose(x, r, atol=2e-3 * float(np.abs(r).max()), err_msg=name)


def test_generate_cli_without_cuda_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _cli_args(corpus, tmp_path, "x", corpus["csv"])]
    i = args.index("--gpu_ids")
    del args[i : i + 2]  # the default: cuda:0
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_cli.main(args)


def test_generate_cli_fused_mdct_off_raises(corpus, tmp_path):
    with pytest.raises(ValueError, match="fused_mdct"):
        generate_cli.main(_cli_args(corpus, tmp_path, "x", corpus["csv"])
                          + ["--fused_mdct", "off"])


def test_generate_cli_refuses_unported_options(corpus, tmp_path):
    """What the port still refuses: the pixelshuffle upsample.  ``--fused_mdct
    on`` for a configuration K1/K2 do not serve raises ``ValueError``, as the
    JAX package's ``use_fused=True`` does.  Several ``--gpu_ids`` serve over
    replicas now, and raise here, without CUDA.  (Local attention and the
    other normalizations build now: ``test_process_file_modes_match_jax``.)"""
    base = _cli_args(corpus, tmp_path, "x", corpus["csv"])
    with pytest.raises(NotImplementedError):
        generate_cli.main(base + ["--upsample_type", "pixelshuffle"])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_cli.main(base + ["--gpu_ids", "0,1"])
    with pytest.raises(ValueError, match="fused_mdct"):
        generate_cli.main(base + ["--raw_mdct", "--fused_mdct", "on"])
    with pytest.raises(ValueError):
        jcli_opt = _jax_opt(tmp_path, ["--raw_mdct"])
        JSpectralTransform(j_spectral_config_from_opt(jcli_opt), use_fused=True)


_SPECTRAL_FLAGS = ("--center", "--arcsinh_transform", "--abs_spectro", "--abs_norm")
# Each case: the flags it adds to FLAGS, and whether it drops the flagship
# spectral flags (the CLI's defaults then: dB, per-sample min/max, no
# centring, one input channel; 8256 samples make 128 frames uncentred).
_MODE_CASES = {
    "raw_mdct": (["--raw_mdct"], False),
    "local_attn": (["--netG", "local", "--n_blocks_local", "1", "--n_blocks_attn_l", "1",
                    "--heads_l", "2", "--dim_head_l", "4", "--proj_factor_l", "2"], False),
    "two_enhancers": (["--netG", "local", "--n_local_enhancers", "2",
                       "--n_blocks_local", "1"], False),
    "db_default": (["--input_nc", "1", "--segment_length", "8256", "--batchSize", "4"], True),
}


@pytest.mark.parametrize("case", sorted(_MODE_CASES))
def test_process_file_modes_match_jax(corpus, tmp_path, monkeypatch, case):
    """One file through each package's ``_process_file`` with options the
    port refused before: SR within 2e-3 of its largest value, LR 1e-5, the
    metrics at their bounds.  In the dB case the JAX CLI feeds one key per
    batch for the pseudo-phase; the file is one batch, and ``randint`` is
    patched to return the draws of the port's ``phase_generators``."""
    extra, bare = _MODE_CASES[case]
    flags = [a for a in FLAGS if not (bare and a in _SPECTRAL_FLAGS)] + extra
    path = str(corpus["wavs"] / "s1.wav")
    jopt = JTrainOptions().parse(flags + ["--checkpoints_dir", str(tmp_path)], save=False)
    opt = options.TrainOptions().parse(flags + ["--checkpoints_dir", str(tmp_path)],
                                       save=False)
    cfg, tcfg = j_spectral_config_from_opt(jopt), options.spectral_config_from_opt(opt)
    flax_g = j_build_generator(jopt)
    params, stats = _flax_vars(flax_g, np.zeros((1, opt.input_nc, 128, 64), np.float32),
                               np.random.default_rng(6), train=False)
    head = "head" if "head" in params else "local_head"
    params[head]["conv"] = {k: v * 0.01 for k, v in params[head]["conv"].items()}
    phase = generate_cli.phase_generators(tcfg, opt.seed)
    assert (phase is not None) == (case == "db_default")
    if phase is not None:
        bits = torch.randint(0, 2, (4, 128, 64), generator=phase(0)).numpy()
        monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(bits))
    jt = JSpectralTransform(cfg, use_fused=False)
    ref = jcli._process_file(path, jopt, cfg, jt,
                             j_build_inference_fn(flax_g, jt, out_length=cfg.segment_length),
                             {"params": params, "batch_stats": stats})
    model = api.create_model(opt, "cpu", state_dict=state_dict_from_jax(params, stats))
    assert model.transform.fused == (case in ("local_attn", "two_enhancers"))
    sr, lr, hr, rate, m = generate_cli._process_file(path, opt, tcfg, model)
    assert rate == ref[3] and sr.shape == ref[0].shape and lr.shape == ref[1].shape
    np.testing.assert_allclose(lr, ref[1], atol=1e-5)
    np.testing.assert_allclose(sr, ref[0], atol=2e-3 * float(np.abs(ref[0]).max()))
    _assert_metrics_close(m, ref[4])


def test_generate_cli_fp16_matches_jax_bf16(corpus, tmp_path):
    """``--fp16``, as ``generate_audio.sh`` passes it: the port serves with
    the bf16 generator (float32 spectra, K1/K2 and denormalization).  One
    file through each package's ``_process_file`` in bf16: the port's SR is
    within 2x the JAX bf16 SR's distance from the port's float32 SR, by max
    and by RMS.  The float32 SR stands for the truth: JAX's float32 SR is
    under a tenth of that distance from it.  Measured: port max 1.35e-5,
    RMS 9.0e-7; JAX max 1.61e-5, RMS 9.7e-7 (the damped head keeps the SR
    band, and so its bf16 rounding, small).  Then the two
    CLIs as a whole, with their metrics within 1e-2 relative (LSD) and
    0.1 dB (SNR) of each other."""
    path = str(corpus["wavs"] / "s1.wav")
    ref = {}
    for fp16 in (False, True):
        jopt = _jax_opt(tmp_path, ["--fp16"] if fp16 else [])
        cfg = j_spectral_config_from_opt(jopt)
        jt = JSpectralTransform(cfg, use_fused=False)
        ref[fp16] = np.asarray(jcli._process_file(
            path, jopt, cfg, jt,
            j_build_inference_fn(j_build_generator(jopt), jt, out_length=8128),
            {"params": corpus["params"], "batch_stats": corpus["stats"]})[0])
    sr = {}
    for fp16 in (False, True):
        opt = options.TrainOptions().parse(
            FLAGS + ["--checkpoints_dir", str(tmp_path)] + (["--fp16"] if fp16 else []),
            save=False)
        model = api.create_model(opt, "cpu", state_dict=state_dict_from_jax(corpus["params"],
                                                                             corpus["stats"]))
        assert model.generator.compute_dtype is (torch.bfloat16 if fp16 else None)
        sr[fp16] = generate_cli._process_file(path, opt, options.spectral_config_from_opt(opt),
                                              model)[0]
    errs = {}
    for name, x in (("port", sr[True]), ("jax", ref[True]), ("f32", ref[False])):
        d = (x - sr[False]).astype(np.float64)
        errs[name] = (float(np.abs(d).max()), float(np.sqrt(np.mean(d ** 2))))
    assert errs["f32"][0] <= 0.1 * errs["jax"][0], errs
    assert errs["port"][0] <= 2 * errs["jax"][0] and errs["port"][1] <= 2 * errs["jax"][1], errs

    wav = corpus["wavs"] / "s1.wav"
    with mock.patch.object(sys, "argv", ["generate_audio.py"]
                           + _cli_args(corpus, tmp_path / "jax", "fp16", wav) + ["--fp16"]):
        jcli.main()
    r = generate_cli.main(_cli_args(corpus, tmp_path / "port", "fp16", wav) + ["--fp16"])
    assert r["rungs"] == [] and (tmp_path / "port" / "fp16" / "sr_audio.wav").exists()
    metrics = {}
    for name in ("port", "jax"):
        line = (tmp_path / name / "fp16" / "metric.txt").read_text().splitlines()[1]
        metrics[name] = dict(zip(("mse", "snr_sr", "lsd"), map(float, line.split(","))))
    assert abs(metrics["port"]["lsd"] - metrics["jax"]["lsd"]) <= 1e-2 * metrics["jax"]["lsd"]
    assert abs(metrics["port"]["snr_sr"] - metrics["jax"]["snr_sr"]) <= 0.1, metrics
