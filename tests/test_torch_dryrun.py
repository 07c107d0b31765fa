"""The port's compile check and data-parallel dry run
(``mdctgan_tpu_torch/dryrun.py``) on the CPU: ``dryrun_multichip`` over two
gloo ranks, its one-rank step against the JAX package's tiny step (the one
``__graft_entry__.dryrun_multichip`` takes) on the same weights and batch,
and ``entry()`` against ``model.inference``."""

import jax
import numpy as np
import optax
import pytest
import torch

from mdctgan_tpu.configs import tiny_discriminator, tiny_generator, tiny_spectral
from mdctgan_tpu.ops.features import SpectralTransform as JSpectralTransform
from mdctgan_tpu.train.state import create_train_state as j_create_train_state
from mdctgan_tpu.train.step import build_train_step as j_build_train_step

from mdctgan_tpu_torch import api, dryrun
from mdctgan_tpu_torch.configs import flagship_opt, tiny_opt
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.options import spectral_config_from_opt
from mdctgan_tpu_torch.train import grad_truth as GT
from mdctgan_tpu_torch.weights import state_dict_from_jax

from test_torch_train import _assert_losses, _assert_normwise


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX dry run's state (``PRNGKey(0)``) and its Adam and SGD(1)
    steps on one device, on the batch of 2 ``dryrun_multichip(2)`` draws."""
    cfg = tiny_spectral()
    gen, disc = tiny_generator(), tiny_discriminator()
    batch = GT.inputs("noise", np.random.default_rng(dryrun.SEED), 2, cfg.segment_length)
    out = {"batch": batch}
    for name, tx in (("adam", optax.adam(2e-4, b1=0.5)), ("sgd", optax.sgd(1.0))):
        state = j_create_train_state(
            jax.random.PRNGKey(0), gen, disc, tx, tx,
            spectro_shape=(cfg.n_bins, cfg.n_fft // 2), g_in_channels=2, d_in_channels=3)
        step = j_build_train_step(gen, disc, JSpectralTransform(cfg), tx, tx,
                                  num_d=2, n_layers_d=2, donate=False)
        after, metrics = step(state, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(1))
        out[name] = jax.device_get((after.g_params, metrics))
        out["init"] = jax.device_get((state.g_params, state.batch_stats, state.d_params))
    return out


def test_tiny_opt_is_the_jax_tiny_configuration():
    cfg, jcfg = spectral_config_from_opt(tiny_opt()), tiny_spectral()
    for k in ("n_fft", "hop_length", "win_length", "segment_length", "n_bins", "center",
              "arcsinh_transform", "abs_norm", "fit_residual", "abs_spectro"):
        assert getattr(cfg, k) == getattr(jcfg, k), k


def test_dryrun_multichip_two_gloo_ranks():
    """Two ranks of one sample each against one process on the batch of 2:
    the JAX dry run's assertions pass; the losses are finite; each rank
    reports its launches, none on the CPU."""
    metrics, launches = dryrun.dryrun_multichip(2, device="cpu")
    assert set(metrics) >= {"loss_G", "loss_D"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert launches == [{name: 0 for name in K.LAUNCHES}] * 2


def test_one_rank_step_matches_the_jax_tiny_step(jax_tiny):
    """The step ``dryrun_multichip`` runs in each rank, as one process on
    the JAX state's weights: the losses within 5e-3 relative and the SGD(1)
    update normwise within 2e-3 (floor 5e-5), the bounds
    ``test_torch_parallel.py`` holds the port's ranks to against the JAX
    mesh."""
    g_params, g_stats, d_params = jax_tiny["init"]
    g_sd, d_sd = state_dict_from_jax(g_params, g_stats), state_dict_from_jax(d_params, {})
    metrics, _ = dryrun.tiny_step(dryrun._ADAM, g_sd, d_sd, jax_tiny["batch"], "cpu")
    _assert_losses(jax_tiny["adam"][1], metrics, 5e-3)
    _, update = dryrun.tiny_step(dryrun._SGD, g_sd, d_sd, jax_tiny["batch"], "cpu")
    sub = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), g_params,
                       jax_tiny["sgd"][0])
    ref = {k: v.numpy() for k, v in state_dict_from_jax(sub, {}).items()}
    assert set(update) == set(ref)
    got = {k: update[k] for k in ref}
    _assert_normwise(ref, got, 2e-3, 5e-5, "generator")


def test_rank_devices_follow_the_gpu_ids_rule(monkeypatch):
    """NCCL takes one card a rank and raises with fewer (JAX clamps); gloo
    puts the ranks on the cards in turn; without CUDA a card raises."""
    assert dryrun.rank_devices(3, "cpu") == ["cpu"] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dryrun.rank_devices(1) == ["cuda:0"]
    with pytest.raises(ValueError, match="1 CUDA device"):
        dryrun.rank_devices(2)
    assert dryrun.rank_devices(2, backend="gloo") == ["cuda:0", "cuda:0"]


def test_entry_equals_model_inference(capsys):
    """``entry(device="cpu")``: a zero segment of the flagship's length, and
    an fn equal to ``model.inference`` of the same seeded flagship bit for
    bit, on that segment and on noise; ``main`` prints the JAX script's
    line."""
    fn, (x,) = dryrun.entry("cpu")
    assert x.shape == (1, flagship_opt()["segment_length"]) and not x.any()
    model = api.create_model(flagship_opt(), "cpu")
    noise = torch.from_numpy(
        (0.1 * np.random.default_rng(3).standard_normal(x.shape)).astype(np.float32))
    for lr in (x, noise):
        out = fn(lr)
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert torch.equal(out, model.inference(lr)[1])
    dryrun.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("entry OK: (1, 32512) torch.float32")
