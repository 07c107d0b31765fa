"""The port's train slice against the JAX reference on the CPU: the
discriminator, the losses, masked BatchNorm, the schedule, freeze labels, the
image pool and whole train steps (SGD(1), where the update is the gradient;
the pool mix; a padded tail batch; a 3-step Adam trajectory; a fix_global
step), on the same seeded weights and inputs.

Sizes: the small LocalEnhancer of ``test_torch_models.py`` (ngf 4, one
attention block) on a (32, 64) spectrum, ``MultiscaleDiscriminator(ndf=4,
n_layers=2, num_D=2)``, batch 4.  Each JAX step is compiled once per module.
"""

import functools
import itertools

import flax.traverse_util as traverse
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdctgan_tpu.models import attention as jattn
from mdctgan_tpu.models import losses as jlosses
from mdctgan_tpu.models.discriminator import MultiscaleDiscriminator as JMultiscaleDiscriminator
from mdctgan_tpu.models.generator import GlobalGenerator as JGlobalGenerator
from mdctgan_tpu.models.generator import LocalEnhancer as JLocalEnhancer
from mdctgan_tpu.ops.features import SpectralConfig as JSpectralConfig
from mdctgan_tpu.ops.features import SpectralTransform as JSpectralTransform
from mdctgan_tpu.train import freeze as jfreeze
from mdctgan_tpu.train import schedule as jschedule
from mdctgan_tpu.train.state import GANTrainState as JGANTrainState
from mdctgan_tpu.train.step import build_train_step as j_build_train_step
from mdctgan_tpu.utils.pool import ImagePool as JImagePool

from mdctgan_tpu_torch.models import attention as tattn
from mdctgan_tpu_torch.models import losses as tlosses
from mdctgan_tpu_torch.models.discriminator import MultiscaleDiscriminator, build_discriminator
from mdctgan_tpu_torch.models.generator import GlobalGenerator, LocalEnhancer
from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform
from mdctgan_tpu_torch.options import train_options
from mdctgan_tpu_torch.train import freeze, schedule
from mdctgan_tpu_torch.train.schedule import OptimizerSpec
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_train_step
from mdctgan_tpu_torch.utils.pool import ImagePool
from mdctgan_tpu_torch.weights import init_weights, state_dict_from_jax

from test_torch_models import SMALL_GLOBAL, SMALL_LOCAL, _flax_vars, _nchw, _nhwc

SPECTRAL = dict(n_fft=128, hop_length=64, win_length=128, segment_length=1984)
HW = (32, 64)  # 1984 samples at hop 64: 32 frames of 64 bins
D_CFG = dict(ndf=4, n_layers=2, num_D=2)
B = 4
MASK = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
# Adam under the flagship's schedule form, decaying within the 3 steps:
# sched(0) = sched(1) = 2e-4, sched(2) = 1e-4
ADAM = dict(lr=2e-4, beta1=0.5, niter=1, niter_decay=2, steps_per_epoch=1)
SGD = OptimizerSpec(functools.partial(torch.optim.SGD, lr=1.0))

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "height": "height", "width": "width"}


def _port_name(path) -> str:
    return ".".join(tuple(str(p) for p in path[:-1]) + (_LEAF[path[-1]],))


# --------------------------------------------------------------------------
# the shared setup: weights, batch, and each JAX step run once
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(11)
    flax_g = JLocalEnhancer(**SMALL_LOCAL)
    flax_d = JMultiscaleDiscriminator(**D_CFG)
    g_params, g_stats = _flax_vars(flax_g, np.zeros((1, 2, *HW), np.float32), rng,
                                   train=False)
    d_params, _ = _flax_vars(flax_d, np.zeros((1, 3, *HW), np.float32), rng)
    t = SPECTRAL["segment_length"]
    hr = (0.1 * rng.standard_normal((B, t))).astype(np.float32)
    lr = (hr + 0.01 * rng.standard_normal((B, t))).astype(np.float32)
    pool_old = rng.normal(0, 0.3, (B, 3, *HW)).astype(np.float32)
    pool_mask = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    return dict(
        flax_g=flax_g, flax_d=flax_d,
        jt=JSpectralTransform(JSpectralConfig(**SPECTRAL), use_fused=False),
        g_params=g_params, g_stats=g_stats, d_params=d_params,
        lr=lr, hr=hr, pool_old=pool_old, pool_mask=pool_mask,
    )


def _run_jax(env, g_tx, d_tx, steps=1, use_pool=False, sample_mask=None):
    """``steps`` JAX steps from the shared weights; the pre-step state, and
    after each step (params, batch_stats, metrics) as numpy trees."""
    step = j_build_train_step(env["flax_g"], env["flax_d"], env["jt"], g_tx, d_tx,
                              n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"],
                              donate=False, use_pool=use_pool)
    state = JGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=env["g_params"],
        d_params=env["d_params"], batch_stats=env["g_stats"],
        g_opt_state=g_tx.init(env["g_params"]), d_opt_state=d_tx.init(env["d_params"]))
    batch = {"lr_audio": jnp.asarray(env["lr"]), "hr_audio": jnp.asarray(env["hr"])}
    args = ()
    if use_pool:
        args = (jnp.asarray(env["pool_old"]), jnp.asarray(env["pool_mask"]))
    mask = None if sample_mask is None else jnp.asarray(sample_mask)
    out = []
    for _ in range(steps):
        state, metrics = step(state, batch, jax.random.PRNGKey(1), *args, sample_mask=mask)
        out.append(jax.device_get((state.g_params, state.batch_stats, state.d_params,
                                   {k: v for k, v in metrics.items() if k != "fake_concat"})))
    return out


@pytest.fixture(scope="module")
def jax_sgd(env):
    sgd = optax.sgd(1.0)
    return _run_jax(env, sgd, sgd)[0]


@pytest.fixture(scope="module")
def jax_sgd_pool(env):
    sgd = optax.sgd(1.0)
    return _run_jax(env, sgd, sgd, use_pool=True)[0]


@pytest.fixture(scope="module")
def jax_sgd_masked(env):
    sgd = optax.sgd(1.0)
    return _run_jax(env, sgd, sgd, sample_mask=MASK)[0]


@pytest.fixture(scope="module")
def jax_adam(env):
    g_tx, d_tx = jschedule.make_optimizers(
        ADAM["lr"], ADAM["beta1"], ADAM["niter"], ADAM["niter_decay"],
        ADAM["steps_per_epoch"])
    return _run_jax(env, g_tx, d_tx, steps=3)


def _port_state(env, g_tx=SGD, d_tx=SGD):
    gen = LocalEnhancer(**SMALL_LOCAL)
    gen.load_state_dict(state_dict_from_jax(env["g_params"], env["g_stats"]), strict=True)
    disc = MultiscaleDiscriminator(3, **D_CFG)
    disc.load_state_dict(state_dict_from_jax(env["d_params"], {}), strict=True)
    return create_train_state(gen, disc, g_tx, d_tx, device="cpu")


def _port_step(env, g_tx=SGD, d_tx=SGD, use_pool=False):
    return build_train_step(SpectralTransform(SpectralConfig(**SPECTRAL), "cpu"), g_tx, d_tx,
                            n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"],
                            use_pool=use_pool)


def _batch(env, rows=B):
    return {"lr_audio": torch.from_numpy(env["lr"][:rows]),
            "hr_audio": torch.from_numpy(env["hr"][:rows])}


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in state.generator.state_dict().items()},
            {k: v.detach().clone() for k, v in state.discriminator.state_dict().items()})


def _deltas(before, module):
    """before - after for every parameter of ``module`` (the gradient under
    SGD(1))."""
    return {k: (before[k] - v.detach()).numpy() for k, v in module.named_parameters()}


def _jax_deltas(env, g_after, d_after):
    sub = lambda a, b: jax.tree.map(lambda x, y: np.asarray(x) - np.asarray(y), a, b)  # noqa: E731
    g = {k: v.numpy() for k, v in state_dict_from_jax(sub(env["g_params"], g_after), {}).items()}
    d = {k: v.numpy() for k, v in state_dict_from_jax(sub(env["d_params"], d_after), {}).items()}
    return g, d


def _assert_normwise(ref, got, rel, floor, label):
    """Per tensor: ||got - ref||_2 <= rel * ||ref||_2 + floor.  The floor
    covers tensors whose true gradient is exactly zero (a conv bias before a
    mean-subtracting norm), where both sides hold f32 dust; wiring errors
    (a leaked, zeroed or misplaced detach) are O(1) here."""
    assert sorted(ref) == sorted(got)
    for name in ref:
        err = float(np.linalg.norm((got[name] - ref[name]).ravel()))
        bound = rel * float(np.linalg.norm(ref[name].ravel())) + floor
        assert err <= bound, f"{label} {name}: ||diff||={err:.3e} > {bound:.3e}"


def _assert_stats(ref_stats, gen, atol):
    ref = state_dict_from_jax({}, ref_stats)
    buffers = dict(gen.named_buffers())
    assert sorted(ref) == sorted(buffers)
    for k, v in ref.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), atol=atol, err_msg=k)


def _assert_losses(ref, got, rtol):
    for k in ("G_GAN", "G_GAN_Feat", "D_real", "D_fake", "loss_G", "loss_D"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, err_msg=k)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("no_lsgan", [False, True])
def test_discriminator_features_match_flax(rng, no_lsgan):
    """Every scale's feature taps and logits, coarsest-named scale first,
    from a strict load of the Flax tree."""
    flax_d = JMultiscaleDiscriminator(**D_CFG, use_sigmoid=no_lsgan)
    disc = build_discriminator(dict(input_nc=2, output_nc=1, ndf=4, n_layers_D=2,
                                    num_D=2, no_lsgan=no_lsgan))
    x = rng.standard_normal((3, 3, *HW)).astype(np.float32)
    params, _ = _flax_vars(flax_d, x, rng)
    ref = flax_d.apply({"params": params}, _nhwc(x))
    disc.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    with torch.no_grad():
        got = disc(torch.from_numpy(x))
    assert list(dict(disc.named_children())) == ["scale1", "scale0"]
    assert len(got) == len(ref) == 2
    for g_scale, r_scale in zip(got, ref):
        assert len(g_scale) == len(r_scale) == 4
        for g, r in zip(g_scale, r_scale):
            r = _nchw(r)
            assert g.shape == r.shape
            np.testing.assert_allclose(g.numpy(), r, atol=1e-5)


def _features(rng, sigmoid):
    """Two scales of three feature maps and a logit map; the logits as
    probabilities when ``sigmoid`` (the BCE form)."""
    feats = []
    for h in (8, 4):
        scale = [rng.standard_normal((B, c, h, 2 * h)).astype(np.float32) for c in (4, 8, 16)]
        logit = rng.standard_normal((B, 1, h, 2 * h)).astype(np.float32)
        scale.append(1 / (1 + np.exp(-logit)) if sigmoid else logit)
        feats.append(scale)
    return feats


@pytest.mark.parametrize("use_lsgan,weighted", list(itertools.product([True, False], [False, True])))
def test_gan_loss_matches_jax(rng, use_lsgan, weighted):
    preds = _features(rng, sigmoid=not use_lsgan)
    w = MASK if weighted else None
    for real in (True, False):
        ref = jlosses.gan_loss([[jnp.asarray(f) for f in s] for s in preds], real, use_lsgan,
                               None if w is None else jnp.asarray(w))
        got = tlosses.gan_loss([[torch.from_numpy(f) for f in s] for s in preds], real,
                               use_lsgan, None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_feature_matching_loss_matches_jax(rng, weighted):
    fake, real = _features(rng, False), _features(rng, False)
    w = MASK if weighted else None
    ref = jlosses.feature_matching_loss(
        [[jnp.asarray(f) for f in s] for s in fake], [[jnp.asarray(f) for f in s] for s in real],
        2, 2, 10.0, None if w is None else jnp.asarray(w))
    t_fake = [[torch.from_numpy(f).requires_grad_() for f in s] for s in fake]
    t_real = [[torch.from_numpy(f).requires_grad_() for f in s] for s in real]
    got = tlosses.feature_matching_loss(t_fake, t_real, 2, 2, 10.0,
                                        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    got.backward()
    assert all(f.grad is None for s in t_real for f in s), "the real side is detached"
    assert t_fake[0][0].grad is not None and t_fake[0][-1].grad is None


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_train_matches_flax(rng, masked):
    """Train-mode output and the new running statistics (momentum 0.1,
    Bessel-corrected variance over the masked rows)."""
    x = (1.5 + 2.0 * rng.standard_normal((B, 6, 4, 8))).astype(np.float32)
    mask = MASK if masked else None
    scale = (1 + 0.1 * rng.standard_normal(6)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(6)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(6)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    y_ref, upd = jattn._BN2D().apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}},
        _nhwc(x), None if mask is None else jnp.asarray(mask), mutable=["batch_stats"])
    bn = tattn._BN2d(6)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    y = bn.train()(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), _nchw(y_ref), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-5)
    # eval mode reads the running statistics and ignores the mask
    before = bn.running_var.clone()
    bn.eval()(torch.from_numpy(x), torch.zeros(B))
    assert torch.equal(bn.running_var, before)


def test_init_weights_on_the_discriminator():
    disc = MultiscaleDiscriminator(3, ndf=16, n_layers=3, num_D=3)
    init_weights(disc, torch.Generator().manual_seed(5))
    weights = torch.cat([m.weight.detach().ravel() for m in disc.modules()
                         if isinstance(m, torch.nn.Conv2d)])
    assert abs(float(weights.std()) - 0.02) < 0.002
    assert all(float(m.bias.abs().max()) == 0.0 for m in disc.modules()
               if isinstance(m, torch.nn.Conv2d))


# --------------------------------------------------------------------------
# schedule, freeze, pool
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lr0,niter,niter_decay,spe", [
    (1.5e-4, 60, 60, 7), (2e-4, 1, 2, 1), (3e-4, 0, 0, 5)])
def test_schedule_matches_jax(lr0, niter, niter_decay, spe):
    ref = jschedule.pix2pixhd_lr_schedule(lr0, niter, niter_decay, spe)
    got = schedule.pix2pixhd_lr_schedule(lr0, niter, niter_decay, spe)
    for count in list(range(0, (niter + niter_decay + 2) * spe + 1)) + [10**6]:
        assert got(count) == float(ref(jnp.int32(count))), count


def test_carry_schedule_count_matches_jax(env):
    """After k updates, the fresh optimizer of the unfreeze carries the
    schedule position k (JAX: the count copied into the new optax state;
    the port: ``state.step``, outside the optimizer) and fresh moments."""
    k = 5
    g_tx, _ = jschedule.make_optimizers(2e-4, 0.5, 1, 3, 2)
    params = {"w": jnp.ones(3)}
    opt_state = g_tx.init(params)
    for _ in range(k):
        _, opt_state = g_tx.update({"w": jnp.ones(3)}, opt_state, params)
    carried = jschedule.carry_schedule_count(opt_state, g_tx.init(params))
    j_count = [s.count for s in jax.tree.leaves(
        carried, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)][0]
    assert int(j_count) == k

    t_g, t_d = schedule.make_optimizers(2e-4, 0.5, 1, 3, 2)
    state = _port_state(env, t_g, t_d)
    step = _port_step(env, t_g, t_d)
    for _ in range(k):
        step(state, _batch(env))
    old_opt = state.g_opt
    state = schedule.carry_schedule_count(state, t_g)
    assert state.g_opt is not old_opt and len(state.g_opt.state) == 0
    assert state.step == k
    step(state, _batch(env))
    j_sched = jschedule.pix2pixhd_lr_schedule(2e-4, 1, 3, 2)
    assert state.g_opt.param_groups[0]["lr"] == float(j_sched(jnp.int32(k)))
    assert state.g_opt.param_groups[0]["lr"] == pytest.approx(2e-4 * 2 / 3, rel=1e-6)
    assert all(s["step"] == 1 for s in state.g_opt.state.values())


@pytest.mark.parametrize("batch,start,freqs,eval_on", [
    (20, 0, (100, 200, 16000, 32000), True),
    (7, 30, (10, 15, 49, 21), False),
    (4, 13, (3, 1, 8, 6), True),
])
def test_freq_clock_matches_jax(batch, start, freqs, eval_on):
    ref = jschedule.FreqClock(batch, start, *freqs, eval_enabled=eval_on)
    got = schedule.FreqClock(batch, start, *freqs, eval_enabled=eval_on)
    for _ in range(400):
        assert got.tick() == ref.tick()


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=5)),
                         ids=lambda f: "".join("1" if v else "0" for v in f))
def test_param_labels_match_jax(flags):
    """Every freeze flag combination, on a LocalEnhancer (a ``global``
    branch beside ``local_*`` modules) and a bare GlobalGenerator."""
    names = ("freeze_g_d", "freeze_g_u", "freeze_l_d", "freeze_l_u", "fix_global")
    kw = dict(zip(names, flags))
    for flax_g, port_g, hw in (
        (JLocalEnhancer(**SMALL_LOCAL), LocalEnhancer(**SMALL_LOCAL), HW),
        (JGlobalGenerator(**SMALL_GLOBAL), GlobalGenerator(**SMALL_GLOBAL), (32, 32)),
    ):
        shapes = jax.eval_shape(lambda: flax_g.init(
            jax.random.PRNGKey(0), jnp.zeros((1, *hw, 2)), train=False))
        ref = {_port_name(k): v for k, v in traverse.flatten_dict(
            jfreeze.param_labels(shapes["params"], **kw)).items()}
        got = freeze.param_labels((n for n, _ in port_g.named_parameters()), **kw)
        assert got == ref


def test_image_pool_matches_jax(rng):
    """The same decisions, old samples and pool contents under one seed,
    through filling, swapping and a short tail commit."""
    ours, ref = ImagePool(5, seed=3), JImagePool(5, seed=3)
    shape = (4, 3, 2, 5)
    for i in range(8):
        got_old, got_mask = ours.presample(shape)
        ref_old, ref_mask = ref.presample(shape)
        np.testing.assert_array_equal(got_mask, ref_mask)
        np.testing.assert_array_equal(got_old, ref_old)
        fakes = rng.standard_normal(shape).astype(np.float32)
        rows = 3 if i == 5 else 4
        ours.commit(fakes[:rows])
        ref.commit(fakes[:rows])
        assert len(ours.images) == len(ref.images)
        for a, b in zip(ours.images, ref.images):
            np.testing.assert_array_equal(a, b)
    assert not ImagePool(0).enabled


# --------------------------------------------------------------------------
# whole steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_pool", [False, True])
def test_sgd_step_matches_jax(env, jax_sgd, jax_sgd_pool, use_pool):
    """One SGD(1) step: losses 5e-3 relative, G and D gradients 2e-3
    normwise (floor 5e-5), the generator's new BatchNorm statistics 1e-5."""
    g_after, stats, d_after, metrics = jax_sgd_pool if use_pool else jax_sgd
    state = _port_state(env)
    g0, d0 = _snapshot(state)
    step = _port_step(env, use_pool=use_pool)
    args = ()
    if use_pool:
        args = (torch.from_numpy(env["pool_old"]), torch.from_numpy(env["pool_mask"]))
    marks = []
    state, got = step(state, _batch(env), *args, mark=marks.append)
    assert state.step == 1
    assert marks == ["k1", "g_forward", "d_forward", "backward", "optimizer"]
    if use_pool:
        assert got["fake_concat"].shape == (B, 3, *HW)
    _assert_losses(metrics, got, 5e-3)
    ref_g, ref_d = _jax_deltas(env, g_after, d_after)
    _assert_normwise(ref_g, _deltas(g0, state.generator), 2e-3, 5e-5, "G grad")
    _assert_normwise(ref_d, _deltas(d0, state.discriminator), 2e-3, 5e-5, "D grad")
    _assert_stats(stats, state.generator, 1e-5)


ATTN_LOCAL = dict(SMALL_LOCAL, n_blocks_local=2, n_attn_local=1, heads_l=2, dim_head_l=4,
                  proj_factor_l=2)
MASKED = dict(SPECTRAL, mask=True, mask_hr=True, sr_sampling_rate=32000, fit_residual=False)


def test_sgd_step_local_attn_masked_matches_jax(env, monkeypatch):
    """One SGD(1) step of a LocalEnhancer with local attention on masked
    spectra (``mask`` and ``mask_hr`` without ``fit_residual``: noise
    fills).  The port draws its fills from the step's ``noise`` generator,
    LR then HR; JAX's ``jax.random.normal`` is patched to return the same
    draws by shape (and seeded noise for its pha jitter, which the step
    discards).

    Held: the losses to JAX's at 5e-3 relative, D's gradients and G's new
    BatchNorm statistics at ``test_sgd_step_matches_jax``'s bounds.  G's
    gradients are held to the JAX step in float64 (``flax_float64``): the
    port's float64 step at 2e-4 normwise and its float32 step, like JAX's
    own float32 step, at 2e-3 (floor 5e-5).  Measured on this draw (printed):
    float64 sides 4.4e-5 apart, float32 sides 3.4e-4 from the truth.

    The weights are drawn from seed 13.  On the draw from seed 12 the
    loss is not smooth within 1e-8 of the weights: along the difference of
    the two float64 gradients its central difference moves from -3.96
    (step 1e-9) to -4.72 (1e-7) and -10.1 (1e-6).  There the two float64
    steps were 1.5% apart and the two float32 steps 1.5% and 7% from JAX's
    float64, as the rounding of each side's spectra picked a different
    one-sided gradient (``PERF.md`` section 7).  Seeds 13 and 14 put
    the two float64 steps within 5.1e-5 of each other."""
    from test_torch_models import flax_float64, to_f64

    from mdctgan_tpu_torch.train.grad_truth import SharedSpectra

    rng = np.random.default_rng(13)
    flax_g = JLocalEnhancer(**ATTN_LOCAL)
    g_params, g_stats = _flax_vars(flax_g, np.zeros((1, 2, *HW), np.float32), rng, train=False)
    cfg = SpectralConfig(**MASKED)
    shapes = [(B, 1, HW[0], cfg.lr_mask_size), (B, 1, HW[0], cfg.hr_mask_size)]
    draws = torch.Generator().manual_seed(5)
    fills = {s: torch.randn(s, generator=draws).numpy() for s in shapes}

    def jax_step(cast):
        other = np.random.default_rng(0)

        def normal(key, shape, dtype=jnp.float32):
            shape = tuple(shape)
            return jnp.asarray(fills[shape] if shape in fills else other.standard_normal(shape),
                               dtype)

        monkeypatch.setattr(jax.random, "normal", normal)
        sgd = optax.sgd(1.0)
        jstep = j_build_train_step(
            flax_g, env["flax_d"], JSpectralTransform(JSpectralConfig(**MASKED), use_fused=False),
            sgd, sgd, n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"], donate=False)
        g_p, d_p, stats = cast(g_params), cast(env["d_params"]), cast(g_stats)
        jstate = JGANTrainState(
            step=jnp.zeros((), jnp.int32), g_params=g_p, d_params=d_p, batch_stats=stats,
            g_opt_state=sgd.init(g_p), d_opt_state=sgd.init(d_p))
        jstate, metrics = jax.device_get(jstep(
            jstate, {"lr_audio": jnp.asarray(env["lr"]), "hr_audio": jnp.asarray(env["hr"])},
            jax.random.PRNGKey(1)))
        g_delta = jax.tree.map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
                               g_p, jstate.g_params)
        return jstate, metrics, {k: v.numpy() for k, v in state_dict_from_jax(g_delta, {}).items()}

    jstate, metrics, jax_g = jax_step(lambda t: t)
    with flax_float64(monkeypatch):
        _, _, truth = jax_step(to_f64)

    g_sd = state_dict_from_jax(g_params, g_stats)

    def port_step(dtype):
        gen = LocalEnhancer(**ATTN_LOCAL).to(dtype)
        gen.load_state_dict(g_sd, strict=True)
        disc = MultiscaleDiscriminator(3, **D_CFG).to(dtype)
        disc.load_state_dict(state_dict_from_jax(env["d_params"], {}), strict=True)
        state = create_train_state(gen, disc, SGD, SGD, device="cpu")
        before = _snapshot(state)
        transform = SpectralTransform(cfg, "cpu")
        if dtype == torch.float64:  # the float32 spectra and fills, in float64
            transform = SharedSpectra(SpectralTransform(cfg, "cpu", dtype), transform)
        step = build_train_step(transform, SGD, SGD, n_layers_d=D_CFG["n_layers"],
                                num_d=D_CFG["num_D"], noise=torch.Generator().manual_seed(5))
        batch = {k: v.to(dtype) for k, v in _batch(env).items()}
        state, got = step(state, batch)
        return state, got, _deltas(before[0], state.generator), _deltas(before[1],
                                                                          state.discriminator)

    state, got, g_delta, d_delta = port_step(torch.float32)
    _assert_losses(metrics, got, 5e-3)
    _, ref_d = _jax_deltas(env, env["g_params"], jstate.d_params)
    _assert_normwise(ref_d, d_delta, 2e-3, 5e-5, "D grad")
    _assert_stats(jstate.batch_stats, state.generator, 1e-5)

    _, got64, g_delta64, _ = port_step(torch.float64)
    _assert_losses(got64, got, 1e-5)
    _assert_normwise(truth, g_delta64, 2e-4, 5e-5, "G grad float64 against JAX float64")
    _assert_normwise(truth, g_delta, 2e-3, 5e-5, "G grad against JAX float64")
    _assert_normwise(truth, jax_g, 2e-3, 5e-5, "JAX's G grad against JAX float64")
    worst = {label: max(float(np.linalg.norm(d[k] - truth[k]) / np.linalg.norm(truth[k]))
                        for k in truth if k.endswith("weight"))
             for label, d in (("port float64", g_delta64), ("port float32", g_delta),
                              ("JAX float32", jax_g))}
    print("G gradient against JAX float64, worst weight tensor (relative):", worst)


def test_masked_step_matches_jax(env, jax_sgd_masked):
    g_after, stats, d_after, metrics = jax_sgd_masked
    state = _port_state(env)
    g0, d0 = _snapshot(state)
    state, got = _port_step(env)(state, _batch(env), sample_mask=torch.from_numpy(MASK))
    _assert_losses(metrics, got, 5e-3)
    ref_g, ref_d = _jax_deltas(env, g_after, d_after)
    _assert_normwise(ref_g, _deltas(g0, state.generator), 2e-3, 5e-5, "G grad")
    _assert_normwise(ref_d, _deltas(d0, state.discriminator), 2e-3, 5e-5, "D grad")
    _assert_stats(stats, state.generator, 1e-5)


def test_masked_step_matches_smaller_batch(env):
    """A batch of 4 with its last row masked steps as the batch of its 3
    real rows: losses 1e-4 relative; gradients and BatchNorm statistics
    1e-4 normwise with a 2e-4 floor (the masked and plain reductions run
    in different orders)."""
    step = _port_step(env)
    masked = _port_state(env)
    g0, d0 = _snapshot(masked)
    masked, m_metrics = step(masked, _batch(env), sample_mask=torch.from_numpy(MASK))
    small = _port_state(env)
    small, s_metrics = step(small, _batch(env, rows=3))
    _assert_losses(s_metrics, m_metrics, 1e-4)
    for label, before, a, b in (("G", g0, masked.generator, small.generator),
                                ("D", d0, masked.discriminator, small.discriminator)):
        _assert_normwise(_deltas(before, b), _deltas(before, a), 1e-4, 2e-4, label)
    _assert_normwise({k: v.numpy() for k, v in small.generator.named_buffers()},
                     {k: v.numpy() for k, v in masked.generator.named_buffers()},
                     1e-4, 2e-4, "stats")


def test_adam_trajectory_matches_jax(env, jax_sgd, jax_adam):
    """Three steps of ``make_optimizers`` (Adam, the epoch-linear decay
    reached within them).  At Adam's first steps the update is about
    lr*sign(grad), so a tensor whose true gradient is zero (f32 dust on both
    sides, found by the SGD(1) step's gradient) may diverge by ~lr; every
    other tensor stays within RMS 0.05*lr, and every tensor within
    2.5*lr*(k+1) at its largest."""
    lr = ADAM["lr"]
    ref_g, ref_d = _jax_deltas(env, jax_sgd[0], jax_sgd[2])
    noise_floor = {k: float(np.sqrt(np.mean(v ** 2))) < 1e-5
                   for k, v in {**ref_g, **ref_d}.items()}
    g_tx, d_tx = schedule.make_optimizers(ADAM["lr"], ADAM["beta1"], ADAM["niter"],
                                          ADAM["niter_decay"], ADAM["steps_per_epoch"])
    state = _port_state(env, g_tx, d_tx)
    step = _port_step(env, g_tx, d_tx)
    lrs = []
    for k, (g_params, _, d_params, metrics) in enumerate(jax_adam):
        state, got = step(state, _batch(env))
        lrs.append(state.g_opt.param_groups[0]["lr"])
        _assert_losses(metrics, got, 5e-3)
        for module, tree in ((state.generator, g_params), (state.discriminator, d_params)):
            ref = {n: v.numpy() for n, v in state_dict_from_jax(tree, {}).items()}
            for name, p in module.named_parameters():
                diff = p.detach().numpy() - ref[name]
                if not noise_floor[name]:
                    rms = float(np.sqrt(np.mean(diff ** 2)))
                    assert rms <= 0.05 * lr, f"step {k + 1} {name}: RMS {rms:.3e}"
                assert float(np.abs(diff).max()) <= 2.5 * lr * (k + 1), f"step {k + 1} {name}"
    assert lrs == pytest.approx([2e-4, 2e-4, 1e-4], rel=1e-6)


def test_fix_global_step_matches_jax(env, jax_sgd):
    """``niter_fix_global``: the global branch is left out of the optimizer
    and does not move at all; the enhancer branch moves as the JAX step
    moves it (the masked optimizer zeroes only the frozen updates, so its
    trainable updates are those of the plain SGD(1) step)."""
    g_after, _, d_after, _ = jax_sgd
    gen_names = [n for n, _ in LocalEnhancer(**SMALL_LOCAL).named_parameters()]
    labels = freeze.param_labels(gen_names, fix_global=True)
    j_labels = {_port_name(k): v for k, v in traverse.flatten_dict(
        jfreeze.param_labels(env["g_params"], fix_global=True)).items()}
    assert labels == j_labels
    assert {"train", "frozen"} == set(labels.values())
    g_tx = freeze.masked_optimizer(SGD, labels)
    state = _port_state(env, g_tx, SGD)
    g0, d0 = _snapshot(state)
    state, _ = _port_step(env, g_tx, SGD)(state, _batch(env))
    got = _deltas(g0, state.generator)
    ref_g, ref_d = _jax_deltas(env, g_after, d_after)
    for name, label in labels.items():
        if label == "frozen":
            assert not got[name].any(), name
    trainable = [n for n, v in labels.items() if v == "train"]
    _assert_normwise({n: ref_g[n] for n in trainable}, {n: got[n] for n in trainable},
                     2e-3, 5e-5, "G grad")
    _assert_normwise(ref_d, _deltas(d0, state.discriminator), 2e-3, 5e-5, "D grad")


def test_shared_spectra_and_slack():
    """``SharedSpectra`` hands the step another transform's spectra in its
    own dtype (the card-against-CPU check feeds both runs K1's output), and
    ``normwise``'s per-tensor slack widens exactly the tensor it names."""
    from mdctgan_tpu_torch.train import grad_truth

    cfg = SpectralConfig(**SPECTRAL)
    f32 = SpectralTransform(cfg, "cpu")
    shared = grad_truth.SharedSpectra(SpectralTransform(cfg, "cpu", torch.float64), f32)
    audio = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1984)))
    for name in ("lr_forward", "hr_forward"):
        got, _, params = getattr(shared, name)(audio)
        ref, _, ref_params = getattr(f32, name)(audio.float())
        assert got.dtype == torch.float64 and params == ref_params
        assert torch.equal(got, ref.double())
    assert shared.cfg is shared.transform.cfg

    ref = {"a": torch.ones(4), "b": torch.ones(4)}
    got = {"a": torch.ones(4) * 1.1, "b": torch.ones(4) * 1.1}  # err 0.2, norm 2
    plain = grad_truth.normwise(ref, got, 0.05, floor=0.0)
    held = grad_truth.normwise(ref, got, 0.05, floor=0.0, slack={"a": 0.1, "b": 0.0})
    assert plain["shares"]["a"] == pytest.approx(2.0)
    assert held["shares"]["a"] == pytest.approx(1.0)
    assert held["shares"]["b"] == pytest.approx(2.0)


def test_float64_step_agrees_with_float32():
    """The port's step runs in float64 too (``train/grad_truth.py`` takes it
    as the truth for float32 runs): at small width the two agree on the
    losses within 1e-5 relative and on the gradients within 1e-2 normwise
    (with these N(0, 0.05) weights float32 alone is ~4e-3 off), and differ:
    the float64 run does not round to float32 anywhere on its way."""
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.train import grad_truth
    from mdctgan_tpu_torch.weights import random_jax_trees

    opt = dict(SPECTRAL, bins=32, netG="local", ngf=4, n_downsample_global=2,
               n_blocks_global=1, n_blocks_local=1, n_blocks_attn_g=1, heads_g=2,
               dim_head_g=4, downsample_type="resconv", upsample_type="interpolate",
               ndf=4, n_layers_D=2, num_D=2)
    rng = np.random.default_rng(4)
    g_sd = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
    d_sd = state_dict_from_jax(*random_jax_trees(build_discriminator(opt), rng))
    batch = grad_truth.inputs("noise", rng, 2, SPECTRAL["segment_length"])
    cpu = torch.device("cpu")
    l64, g64 = grad_truth.sgd_grads(opt, g_sd, d_sd, batch, cpu, torch.float64)
    l32, g32 = grad_truth.sgd_grads(opt, g_sd, d_sd, batch, cpu)
    for k, v in l64.items():
        assert l32[k] == pytest.approx(v, rel=1e-5), k
    for net in ("G", "D"):
        got = grad_truth.normwise(g64[net], g32[net], 1e-2, 5e-5)
        assert got["max_share"] <= 1.0, got["worst"]
        assert got["max_rel_err"] > 1e-7


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def test_create_train_state_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(LocalEnhancer(**SMALL_LOCAL), MultiscaleDiscriminator(3, **D_CFG),
                           SGD, SGD)


def test_unported_train_options_raise():
    """No train option is refused now: ``accum_steps`` came with the train
    CLI, ``fp16`` (a bf16 discriminator) with the bf16 policy and
    ``multihost`` with data parallelism."""
    assert train_options({})["num_D"] == 2
    assert train_options({"accum_steps": 2})["accum_steps"] == 2
    assert train_options({"fp16": True})["fp16"] is True
    assert build_discriminator({"fp16": True}).scale0.layer0.compute_dtype is torch.bfloat16
    assert train_options({"multihost": True}) == train_options({})
