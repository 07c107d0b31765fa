"""The plain reference against the port, on the CPU at a tiny configuration
on seeded weights, and what the reference imports."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import perfbench_tiny as T
from perfbench import checks
from perfbench.reference import models, serve, train, transform
from perfbench.weights import seeded_state_dicts

OPT = T.TRAIN


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dicts(OPT, "cpu", 2**31 + 7)


def port_nets(g_sd, d_sd):
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator

    g, d = build_generator(OPT), build_discriminator(OPT)
    g.load_state_dict({k: v.clone() for k, v in g_sd.items()})
    d.load_state_dict(d_sd)
    return g, d


def ref_nets(g_sd, d_sd):
    g, d = models.build_generator(OPT), models.Discriminator(OPT)
    g.load_state_dict(g_sd)
    d.load_state_dict(d_sd)
    return g, d


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_state_dicts_have_the_ports_layout(which):
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator

    opt = OPT if which == "tiny" else flagship_opt()
    with torch.device("meta"):
        ours = (models.build_generator(opt), models.Discriminator(opt))
        port = (build_generator(opt), build_discriminator(opt))
    for a, b in zip(ours, port):
        assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in b.state_dict().items()}


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_generator_and_discriminator_match_the_port(weights, mode):
    pg, pd = port_nets(*weights)
    rg, rd = ref_nets(*weights)
    for net in (pg, pd, rg, rd):
        getattr(net, mode)()
    x = torch.randn(3, 2, OPT["bins"], OPT["n_fft"] // 2, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(rg(x), pg(x), rtol=1e-5, atol=1e-5)
    y = torch.cat((x, x[:, :1]), dim=1)
    for a, b in zip(rd(y), pd(y)):
        for fa, fb in zip(a, b):
            torch.testing.assert_close(fa, fb, rtol=1e-5, atol=1e-5)


def test_transform_matches_the_ports_plain_kernels():
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import spectral_config_from_opt

    st = SpectralTransform(spectral_config_from_opt(OPT), "cpu")
    tr = transform.Transform(OPT["n_fft"], OPT["arcsinh_gain"], OPT["src_range"],
                             OPT["norm_range"], "cpu")
    audio = 0.1 * torch.randn(2, OPT["segment_length"], generator=torch.Generator().manual_seed(1))
    spec, _, bounds = st.lr_forward(audio)
    torch.testing.assert_close(tr.spectrum(audio), spec, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tr.audio(spec), st.to_audio(spec, bounds), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rates", [(16000, 48000), (48000, 16000), (44100, 48000)])
def test_resample_matches_the_port(rates):
    from mdctgan_tpu_torch.ops.resample import resample

    x = torch.randn(2, 1234, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(transform.resample(x, *rates), resample(x, *rates))


def test_train_step_matches_the_port(weights):
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import spectral_config_from_opt
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step

    g_sd, d_sd = weights
    g_tx, d_tx = make_optimizers(OPT["lr"], OPT["beta1"], 60, 60, 2000)
    state = create_train_state(*port_nets(g_sd, d_sd), g_tx, d_tx, device="cpu")
    step = build_train_step(SpectralTransform(spectral_config_from_opt(OPT), "cpu"), g_tx, d_tx,
                            n_layers_d=OPT["n_layers_D"], num_d=OPT["num_D"])
    gen = torch.Generator().manual_seed(3)
    raw = 0.1 * torch.randn(4, OPT["segment_length"], generator=gen)
    lr, hr = transform.degrade(raw, 48000, 16000, 48000, OPT["segment_length"])
    state, metrics = step(state, {"lr_audio": lr, "hr_audio": hr})
    ref = train.follow(*ref_nets(g_sd, d_sd),
                       transform.Transform(OPT["n_fft"], OPT["arcsinh_gain"], OPT["src_range"],
                                           OPT["norm_range"], "cpu"), [(lr, hr)], OPT)
    checks.add_norms(ref)
    for k in ("G_GAN", "G_GAN_Feat", "D_real", "D_fake", "loss_G", "loss_D"):
        assert float(metrics[k]) == pytest.approx(ref["losses"][0][k], rel=1e-5)
    # the first step's gradient, from Adam's first moment (1 - beta1) g
    moments = {**state.g_opt.state, **state.d_opt.state}
    for net, prefix in ((state.generator, "G."), (state.discriminator, "D.")):
        grads = {prefix + k: moments[p]["exp_avg"] / (1 - OPT["beta1"])
                 for k, p in net.named_parameters()}
        median = float(np.median([ref["grad_norms"][k] for k in grads]))
        for k, g in grads.items():
            room = 1e-4 * max(ref["grad_norms"][k], median)
            assert abs(float(g.norm()) - ref["grad_norms"][k]) <= room, k
            assert float((g - ref["grads"][k]).norm()) <= room, k


def test_serving_matches_the_port(weights):
    from mdctgan_tpu_torch import api

    g_sd, _ = weights
    model = api.create_model(T.GENERATE, "cpu", state_dict=g_sd)
    rng = np.random.default_rng(4)
    waves = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (100, 700, 1500)]
    served = [api.upsample(w, 16000, model, is_lr_input=True, batch_size=2) for w in waves]
    g = models.build_generator(T.GENERATE)
    g.load_state_dict(g_sd)
    tr = transform.Transform(OPT["n_fft"], OPT["arcsinh_gain"], OPT["src_range"],
                             OPT["norm_range"], "cpu")
    for y, r in zip(served, serve.upsample_many(waves, 16000, g, tr, T.GENERATE, "cpu", 2)):
        assert y.shape == r.shape
        np.testing.assert_allclose(y, r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mdctgan_tpu"}


@pytest.mark.parametrize("modules,banned", [
    (["perfbench.reference.models", "perfbench.reference.train", "perfbench.reference.serve",
      "perfbench.reference.transform", "perfbench.reference.precision"],
     FORBIDDEN | {"mdctgan_tpu_torch"}),
    (["perfbench.harness", "perfbench.checks", "perfbench.flops", "perfbench.trace",
      "perfbench.readers", "perfbench.roofline", "perfbench.weights", "perfbench.traffic.mix",
      "perfbench.calibrate"], FORBIDDEN),
])
def test_imports_nothing_banned(modules, banned):
    """Whole top-level names: the port's ``mdctgan_tpu_torch`` begins with
    the JAX package's name and is not it."""
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=T.REPO, capture_output=True,
                         text=True, check=True)
    assert not set(json.loads(out.stdout)) & banned
