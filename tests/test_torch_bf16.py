"""The bf16 policy (``--fp16``) on the CPU, against the JAX package's bf16
modules and a float64 truth.

bf16 keeps 8 significant bits, so neither side is a bit-exact target for
the other: XLA may keep bf16 intermediates in float32 on the CPU, and the
two frameworks round their convolutions' partial sums differently.  Each
check therefore measures the JAX bf16 error and the port's bf16 error
against the port's float64 module on the same weights and inputs, and holds
the port to at most twice the JAX error, by max and by RMS (``_within``).
The measured ratios (port / JAX) are written beside each test.  Beside
them: the output dtype of every module equals Flax's, block by block, and
the JAX package's own check ``|bf16 - f32| <= 0.1`` on the outputs.

Sizes: the small generators of ``test_torch_models.py`` and the
discriminator and batch of ``test_torch_train.py``.
"""

import functools

import flax.traverse_util as traverse
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdctgan_tpu.models import attention as jattn
from mdctgan_tpu.models import generator as jgen
from mdctgan_tpu.models import layers as jlayers
from mdctgan_tpu.models.discriminator import MultiscaleDiscriminator as JMultiscaleDiscriminator
from mdctgan_tpu.train.state import GANTrainState as JGANTrainState
from mdctgan_tpu.train.step import build_train_step as j_build_train_step

from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.models import attention as tattn
from mdctgan_tpu_torch.models import generator as tgen
from mdctgan_tpu_torch.models import layers as tlayers
from mdctgan_tpu_torch.models.discriminator import MultiscaleDiscriminator, build_discriminator
from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform
from mdctgan_tpu_torch.options import train_options
from mdctgan_tpu_torch.train import grad_truth
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager
from mdctgan_tpu_torch.train.restore import load_generator_state
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_train_step
from mdctgan_tpu_torch.weights import state_dict_from_jax

from test_torch_models import SMALL_GLOBAL, SMALL_LOCAL, _flax_vars, _nchw, _nhwc
from test_torch_train import B, D_CFG, HW, SGD, SPECTRAL

BF16 = torch.bfloat16
# the global resblock after the attention stack carries the float32 stream
DTYPE_LOCAL = dict(SMALL_LOCAL, n_blocks_global=2)


def _errors(got, truth):
    d = (torch.as_tensor(np.asarray(got, np.float64)) if not torch.is_tensor(got)
         else got.detach().double()) - truth
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def _within(got, ref, truth, label, factor=2.0):
    """The port's error against ``truth`` at most ``factor`` times the JAX
    error, by max and by RMS; returns the two ratios."""
    p, j = _errors(got, truth), _errors(ref, truth)
    ratios = (p[0] / j[0], p[1] / j[1])
    assert ratios[0] <= factor and ratios[1] <= factor, (
        f"{label}: port max {p[0]:.3e} RMS {p[1]:.3e}, JAX max {j[0]:.3e} RMS {j[1]:.3e}")
    return ratios


def _port(module, params, stats, dtype=None):
    module.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return module.to(dtype) if dtype is not None else module


# --------------------------------------------------------------------------
# layers and blocks
# --------------------------------------------------------------------------

_BLOCKS = {
    # name: (flax bf16 module, port module (dtype), input shape, flax kwargs)
    "conv": (lambda d: jlayers.Conv(6, 3, 1, 1, dtype=d),
             lambda d: tlayers.Conv(8, 6, 3, 1, 1, dtype=d), (2, 8, 10, 12), {}),
    "conv_transposed": (lambda d: jlayers.ConvTransposed(4, dtype=d),
                        lambda d: tlayers.ConvTransposed(8, 4, dtype=d), (2, 8, 5, 7), {}),
    "interpolate_upsample": (lambda d: jlayers.InterpolateUpsample(8, 4, dtype=d),
                             lambda d: tlayers.InterpolateUpsample(8, 4, dtype=d),
                             (2, 8, 6, 10), {}),
    "conv_res_block": (lambda d: jlayers.ConvResBlock(8, 16, dtype=d),
                       lambda d: tlayers.ConvResBlock(8, 16, dtype=d), (2, 8, 12, 16), {}),
    "resnet_block": (lambda d: jlayers.ResnetBlock(8, dtype=d),
                     lambda d: tlayers.ResnetBlock(8, dtype=d), (2, 8, 10, 12), {}),
    "bottle_block_shortcut": (
        lambda d: jattn.BottleBlock(16, (4, 8), proj_factor=4, heads=2, dim_head=4, dtype=d),
        lambda d: tattn.BottleBlock(8, 16, (4, 8), proj_factor=4, heads=2, dim_head=4, dtype=d),
        (2, 8, 4, 8), {"train": False}),
    "bottle_stack": (
        lambda d: jattn.BottleStack(16, (4, 8), num_layers=2, heads=2, dim_head=4, dtype=d),
        lambda d: tattn.BottleStack(8, 16, (4, 8), num_layers=2, heads=2, dim_head=4, dtype=d),
        (2, 8, 4, 8), {"train": False}),
}


@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_block_bf16_against_float64(rng, name):
    """Each block in bf16 on a float32 input: the output dtype of Flax's,
    and the error against the float64 block within 2x the JAX error.
    Measured ratios (max, RMS): conv 0.73/0.89, conv_transposed 0.57/0.84,
    interpolate_upsample 0.73/0.83, conv_res_block 0.73/0.84, resnet_block
    1.00/0.96, bottle_block_shortcut 0.95/1.21, bottle_stack 0.85/1.22."""
    flax_f, torch_f, shape, kw = _BLOCKS[name]
    x = rng.standard_normal(shape).astype(np.float32)
    params, stats = _flax_vars(flax_f(None), x, rng, **kw)
    ref = jax.jit(functools.partial(flax_f(jnp.bfloat16).apply, **kw))(
        {"params": params, "batch_stats": stats}, _nhwc(x))
    truth = _port(torch_f(None), params, stats, torch.float64).eval()
    got = _port(torch_f(BF16), params, stats).eval()
    with torch.no_grad():
        want = truth(torch.from_numpy(x).double())
        out = got(torch.from_numpy(x))
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    assert all(p.dtype == torch.float32 for p in got.parameters())
    _within(out, _nchw(ref.astype(jnp.float32)), want, name)


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_bf16_matches_jax(rng, relu):
    """A bf16 input stays bf16, with float32 statistics: the JAX package's
    rounding points (``mdctgan_tpu/ops/norm.py``), so the two agree to one
    bf16 rounding of the output (2^-8 relative) where XLA keeps no excess
    precision."""
    from mdctgan_tpu.ops.norm import instance_norm_fused

    x = (3.0 + rng.standard_normal((2, 5, 9, 14))).astype(np.float32)
    xb = torch.from_numpy(x).to(BF16)
    fn = tlayers.instance_norm_relu if relu else tlayers.instance_norm
    got = fn(xb)
    ref = instance_norm_fused(_nhwc(xb.float().numpy()).astype(jnp.bfloat16), relu=relu)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    ref = _nchw(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2 ** -6, rtol=2 ** -7)
    truth = fn(xb.double())
    _within(got, ref, truth, "instance_norm")


# --------------------------------------------------------------------------
# generators and the discriminator
# --------------------------------------------------------------------------

_GENERATORS = {
    "local": (lambda d: jgen.LocalEnhancer(**SMALL_LOCAL, dtype=d),
              lambda d: tgen.LocalEnhancer(**SMALL_LOCAL, dtype=d), (2, 2, 32, 64)),
    "global_transconv": (
        lambda d: jgen.GlobalGenerator(**dict(SMALL_GLOBAL, upsample_type="transconv"), dtype=d),
        lambda d: tgen.GlobalGenerator(**dict(SMALL_GLOBAL, upsample_type="transconv"), dtype=d),
        (2, 2, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(_GENERATORS))
def test_generator_bf16_against_float64(rng, name):
    """The bf16 generator (eval mode) returns float32 on float32 parameters;
    its output is within 2x the JAX bf16 error of the float64 generator, and
    within the JAX package's 0.1 of the float32 one.  Measured ratios
    (max, RMS): local 0.96/0.89 (JAX max 0.052, RMS 0.011),
    global_transconv 0.77/0.96."""
    flax_f, torch_f, shape = _GENERATORS[name]
    x = rng.standard_normal(shape).astype(np.float32)
    params, stats = _flax_vars(flax_f(None), x, rng, train=False)
    ref, ref32 = (jax.jit(functools.partial(flax_f(d).apply, train=False))(
        {"params": params, "batch_stats": stats}, _nhwc(x)) for d in (jnp.bfloat16, None))
    with torch.no_grad():
        truth = _port(torch_f(None), params, stats, torch.float64).eval()(
            torch.from_numpy(x).double())
        gen = _port(torch_f(BF16), params, stats).eval()
        got = gen(torch.from_numpy(x))
        logits = gen.logits(torch.from_numpy(x))
    assert got.dtype == logits.dtype == torch.float32 and ref.dtype == jnp.float32
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    assert torch.equal(torch.tanh(logits), got)
    _within(got, _nchw(ref), truth, name)
    assert float(np.abs(got.numpy() - _nchw(ref32)).max()) <= 0.1


def _flax_dtypes(module, variables, x, **kw):
    _, inter = jax.eval_shape(functools.partial(
        module.apply, capture_intermediates=True, mutable=["intermediates"], **kw),
        variables, x)
    out = {}
    for path, value in traverse.flatten_dict(inter["intermediates"]).items():
        if path[-1] == "__call__" and hasattr(value[0], "dtype"):
            out[".".join(path[:-1])] = str(value[0].dtype)
    return out


def _port_dtypes(module, *args):
    out, hooks = {}, []
    for name, sub in module.named_modules():
        def hook(mod, inputs, output, name=name):
            if torch.is_tensor(output):
                out[name] = str(output.dtype).split(".")[-1]
        hooks.append(sub.register_forward_hook(hook))
    with torch.no_grad():
        module(*args)
    for h in hooks:
        h.remove()
    return out


@pytest.mark.parametrize("name", ["local", "global", "discriminator"])
def test_dtype_flow_matches_flax(rng, name):
    """Every port module that runs (each conv wrapper, norm, resblock,
    attention part, up/down block and the whole net) returns the dtype its
    Flax twin returns under the bf16 policy: bf16 up to the attention stack,
    float32 out of it and along the global resblocks after it until the
    first upsample, bf16 again from there to the head, float32 out of the
    head and out of the discriminator's logit conv."""
    if name == "discriminator":
        flax_m = JMultiscaleDiscriminator(**D_CFG, dtype=jnp.bfloat16)
        port_m = MultiscaleDiscriminator(3, **D_CFG, dtype=BF16)
        x, kw = rng.standard_normal((2, 3, *HW)).astype(np.float32), {}
    else:
        cfg = DTYPE_LOCAL if name == "local" else SMALL_GLOBAL
        cls = "LocalEnhancer" if name == "local" else "GlobalGenerator"
        flax_m = getattr(jgen, cls)(**cfg, dtype=jnp.bfloat16)
        port_m = getattr(tgen, cls)(**cfg, dtype=BF16)
        x, kw = rng.standard_normal((2, 2, *cfg["input_size"])).astype(np.float32), \
            {"train": False}
    params, stats = _flax_vars(flax_m, x, rng, **kw)
    ref = _flax_dtypes(flax_m, {"params": params, "batch_stats": stats}, _nhwc(x), **kw)
    got = _port_dtypes(_port(port_m, params, stats).eval(), torch.from_numpy(x))
    assert set(got) <= set(ref), sorted(set(got) - set(ref))
    assert {k: got[k] for k in got} == {k: ref[k] for k in got}
    if name == "local":
        assert len(got) >= 40
        assert (got["global.res0"], got["global.attn"], got["global.res1"],
                got["global.up0"], got[""]) == ("bfloat16", "float32", "float32",
                                                "bfloat16", "float32")
    if name == "discriminator":
        assert (got["scale1.layer2"], got["scale1.layer3"]) == ("bfloat16", "bfloat16")


def _cat(feats):
    return torch.cat([(f.double() if torch.is_tensor(f)
                       else torch.from_numpy(np.asarray(f, np.float64))).ravel() for f in feats])


def test_discriminator_bf16_against_float64(rng):
    """Every feature tap and logit map of both scales, by max and RMS over
    the scale's taps: within 2x the JAX bf16 error of the float64
    discriminator.  Measured ratios (max, RMS): the full-resolution scale
    0.80/0.86, the pooled one 0.92/0.94."""
    flax_d = JMultiscaleDiscriminator(**D_CFG, dtype=jnp.bfloat16)
    x = rng.standard_normal((2, 3, *HW)).astype(np.float32)
    params, _ = _flax_vars(JMultiscaleDiscriminator(**D_CFG), x, rng)
    ref = jax.jit(flax_d.apply)({"params": params}, _nhwc(x))
    with torch.no_grad():
        truth = _port(MultiscaleDiscriminator(3, **D_CFG), params, {}, torch.float64)(
            torch.from_numpy(x).double())
        got = _port(MultiscaleDiscriminator(3, **D_CFG, dtype=BF16), params, {})(
            torch.from_numpy(x))
    for s in range(2):
        assert [f.dtype for f in got[s]] == [BF16] * 3 + [torch.float32]
        _within(_cat(got[s]), _cat([_nchw(f.astype(jnp.float32)) for f in ref[s]]).numpy(),
                _cat(truth[s]), f"scale {s}")


def test_build_functions_take_fp16():
    """``fp16`` reaches both builders; the flagship dict stays float32."""
    from mdctgan_tpu_torch.configs import flagship_opt

    assert train_options({"fp16": True})["fp16"] is True
    for fp16, want in ((False, None), (True, BF16)):
        g = tgen.build_generator(dict(flagship_opt(), fp16=fp16))
        d = build_discriminator(dict(flagship_opt(), fp16=fp16))
        assert g.compute_dtype is want and g.coarse.attn.block0.attn.compute_dtype is want
        assert d.scale0.layer0.compute_dtype is want
        assert all(p.dtype == torch.float32 for p in g.parameters())
    assert "fp16" not in flagship_opt()


def test_float32_policy_turns_off_bf16_reduced_reductions():
    """The policy sets cuBLAS's bf16 reduced-precision reduction off (it is
    on by default) and gives the caller's value back on exit."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        with float32_policy():
            assert matmul.allow_bf16_reduced_precision_reduction is False
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------

DRAWS = 3  # input batches through one set of weights


@pytest.fixture(scope="module")
def step_env():
    """Seeded weights, ``DRAWS`` batches and the JAX bf16 SGD(1) step's
    losses and gradients on each."""
    from mdctgan_tpu.ops.features import SpectralConfig as JSpectralConfig
    from mdctgan_tpu.ops.features import SpectralTransform as JSpectralTransform

    rng = np.random.default_rng(11)
    g_params, g_stats = _flax_vars(jgen.LocalEnhancer(**SMALL_LOCAL),
                                   np.zeros((1, 2, *HW), np.float32), rng, train=False)
    d_params, _ = _flax_vars(JMultiscaleDiscriminator(**D_CFG),
                             np.zeros((1, 3, *HW), np.float32), rng)
    t = SPECTRAL["segment_length"]
    batches = []
    for _ in range(DRAWS):
        hr = (0.1 * rng.standard_normal((B, t))).astype(np.float32)
        batches.append({"lr_audio": (hr + 0.01 * rng.standard_normal((B, t))).astype(np.float32),
                        "hr_audio": hr})
    sgd = optax.sgd(1.0)
    step = j_build_train_step(
        jgen.LocalEnhancer(**SMALL_LOCAL, dtype=jnp.bfloat16),
        JMultiscaleDiscriminator(**D_CFG, dtype=jnp.bfloat16),
        JSpectralTransform(JSpectralConfig(**SPECTRAL), use_fused=False), sgd, sgd,
        n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"], donate=False)
    state = JGANTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params,
                           d_params=d_params, batch_stats=g_stats,
                           g_opt_state=sgd.init(g_params), d_opt_state=sgd.init(d_params))
    sub = lambda a, b: jax.tree.map(  # noqa: E731
        lambda x, y: np.asarray(x, np.float64) - np.asarray(y, np.float64), a, b)
    jax_runs = []
    for batch in batches:
        after, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(1))
        jax_runs.append(({k: float(v) for k, v in metrics.items()},
                         {"G": state_dict_from_jax(sub(g_params, after.g_params), {}),
                          "D": state_dict_from_jax(sub(d_params, after.d_params), {})}))
    return dict(g_params=g_params, g_stats=g_stats, d_params=d_params, batches=batches,
                jax=jax_runs)


def _port_sgd(env, dtype, batch, use_pool=False):
    """One SGD(1) step of the port: nets built with compute ``dtype``
    (``None`` for float64, whose transform is fed the float32 spectra)."""
    opt = {"n_layers_D": D_CFG["n_layers"], "num_D": D_CFG["num_D"]}
    g = _port(tgen.LocalEnhancer(**SMALL_LOCAL, dtype=dtype), env["g_params"], env["g_stats"])
    d = _port(MultiscaleDiscriminator(3, **D_CFG, dtype=dtype), env["d_params"], {})
    cfg = SpectralConfig(**SPECTRAL)
    transform = SpectralTransform(cfg, "cpu")
    if dtype is None:
        g, d = g.double(), d.double()
        transform = grad_truth.SharedSpectra(SpectralTransform(cfg, "cpu", torch.float64),
                                             transform)
    return grad_truth.sgd_step(opt, {"G": g, "D": d}, transform, batch, "cpu")


def _block(name):
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "global" or parts[0].startswith("scale") \
        else parts[0]


def test_bf16_step_against_float64(step_env):
    """One SGD(1) step of the bf16 G and D on ``DRAWS`` batches: the six
    losses, and the gradients of every top-level block (each global stage,
    each enhancer stage, each discriminator layer), pooled over the draws,
    within 2x the JAX bf16 step's error against the float64 step, by max and
    by RMS.  Measured ratios (max, RMS): the losses 1.24/1.09; per block
    the worst 1.08 (``local_res0`` max) and 1.13 (``global.attn`` RMS),
    most 0.7-1.05.  JAX's logit conv of D (``layer3``) is 2-100x less
    accurate than the port's: Flax adds its bias after the bf16 rounding."""
    env = step_env
    losses = {"port": [], "jax": [], "truth": []}
    grads = {k: {"G": [], "D": []} for k in losses}
    for batch, (j_metrics, j_grads) in zip(env["batches"], env["jax"]):
        l64, g64 = _port_sgd(env, None, batch)
        l16, g16 = _port_sgd(env, BF16, batch)
        for tag, (ls, gs) in (("truth", (l64, g64)), ("port", (l16, g16)),
                              ("jax", (j_metrics, j_grads))):
            losses[tag].append(torch.tensor([ls[k] for k in sorted(l64)], dtype=torch.float64))
            for net in ("G", "D"):
                grads[tag][net].append({k: v.double() for k, v in gs[net].items()})
    _within(torch.cat(losses["port"]), torch.cat(losses["jax"]).numpy(),
            torch.cat(losses["truth"]), "losses")
    for net in ("G", "D"):
        names = list(grads["truth"][net][0])
        for block in sorted({_block(n) for n in names}):
            pick = lambda runs: torch.cat([r[n].ravel() for r in runs for n in names  # noqa: E731
                                           if _block(n) == block])
            _within(pick(grads["port"][net]), pick(grads["jax"][net]).numpy(),
                    pick(grads["truth"][net]), f"{net} {block}")


def test_bf16_step_keeps_float32_state(step_env):
    """Under bf16 the parameters, their gradients, the BatchNorm statistics,
    the losses and the pool's fakes stay float32, and all are finite."""
    env = step_env
    g = _port(tgen.LocalEnhancer(**SMALL_LOCAL, dtype=BF16), env["g_params"], env["g_stats"])
    d = _port(MultiscaleDiscriminator(3, **D_CFG, dtype=BF16), env["d_params"], {})
    state = create_train_state(g, d, SGD, SGD, device="cpu")
    step = build_train_step(SpectralTransform(SpectralConfig(**SPECTRAL), "cpu"), SGD, SGD,
                            n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"], use_pool=True)
    batch = {k: torch.from_numpy(v) for k, v in env["batches"][0].items()}
    old = torch.zeros(B, 3, *HW)
    state, metrics = step(state, batch, old, torch.tensor([1.0, 0.0, 1.0, 0.0]))
    assert metrics["fake_concat"].dtype == torch.float32
    for name, t in [*g.named_parameters(), *d.named_parameters(), *g.named_buffers()]:
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all()), name
    for p in [*g.parameters(), *d.parameters()]:
        assert p.grad.dtype == torch.float32
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in metrics.values())


def test_checkpoint_serves_across_precisions(step_env, tmp_path):
    """Parameters stay float32, so the checkpoint format does not change: a
    bf16 run's ``ckpt/`` loads into the float32 generator and a float32
    run's into the bf16 one, tensor for tensor."""
    env = step_env
    opt = dict(netG="local", ngf=4, n_downsample_global=2, n_blocks_global=1,
               n_blocks_local=1, n_blocks_attn_g=1, heads_g=2, dim_head_g=4, bins=32,
               n_fft=128, downsample_type="resconv", upsample_type="interpolate",
               ndf=4, n_layers_D=2, num_D=2)
    for saved_fp16, run in ((True, "bf16_run"), (False, "f32_run")):
        g = tgen.build_generator(dict(opt, fp16=saved_fp16))
        d = build_discriminator(dict(opt, fp16=saved_fp16))
        g.load_state_dict(state_dict_from_jax(env["g_params"], env["g_stats"]))
        d.load_state_dict(state_dict_from_jax(env["d_params"], {}))
        state = create_train_state(g, d, SGD, SGD, device="cpu")
        build_train_step(SpectralTransform(SpectralConfig(**SPECTRAL), "cpu"), SGD, SGD,
                         n_layers_d=2, num_d=2)(
            state, {k: torch.from_numpy(v) for k, v in env["batches"][0].items()})
        mgr = CheckpointManager(str(tmp_path / run / "ckpt"))
        mgr.save(state, epoch=1)
        mgr.close()
        serve = tgen.build_generator(dict(opt, fp16=not saved_fp16))
        sd, rungs = load_generator_state(
            {"load_pretrain": str(tmp_path / run), "which_epoch": "latest"}, serve)
        serve.load_state_dict(sd, strict=True)
        assert rungs == [] and serve.compute_dtype is (None if saved_fp16 else BF16)
        for k, v in g.state_dict().items():
            assert v.dtype == torch.float32 and torch.equal(serve.state_dict()[k], v), k
