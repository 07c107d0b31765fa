"""The port's layers, attention and generators against the Flax reference
(eval mode) on the same seeded weights, carried by
``weights.state_dict_from_jax``.  CPU, float32, absolute bounds."""

import contextlib
import functools

import flax.traverse_util as traverse
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdctgan_tpu.configs import flagship_generator
from mdctgan_tpu.models import attention as jattn
from mdctgan_tpu.models import generator as jgen
from mdctgan_tpu.models import layers as jlayers
from mdctgan_tpu.ops import norm as jnorm
from mdctgan_tpu.train.import_torch import export_to_torch_keys, generator_entries_for

from mdctgan_tpu_torch.configs import flagship_opt
from mdctgan_tpu_torch.models import attention as tattn
from mdctgan_tpu_torch.models import generator as tgen
from mdctgan_tpu_torch.models import layers as tlayers
from mdctgan_tpu_torch.weights import init_weights, random_jax_trees, state_dict_from_jax

from test_import_gold import SMALL_LOCAL_ATTN_ONLY, SMALL_LOCAL_BOTH_ATTN, SMALL_LOCAL_N2


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def _flax_vars(module, x, rng, **kw):
    """Seeded numpy values in the shapes of ``module``'s Flax variables:
    parameters N(0, 0.05), running means N(0, 0.1), variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), _nhwc(x), **kw))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.05, s.shape).astype(np.float32),
        shapes["params"])
    flat = traverse.flatten_dict(shapes.get("batch_stats", {}))
    stats = {
        k: (rng.normal(0.0, 0.1, s.shape) if k[-1] == "mean"
            else rng.uniform(0.5, 1.5, s.shape)).astype(np.float32)
        for k, s in flat.items()
    }
    return params, traverse.unflatten_dict(stats) if stats else {}


def _in_stats_f64(x, relu):
    """``mdctgan_tpu.ops.norm``'s instance-norm statistics in the input's
    dtype (the package accumulates them in float32 even for a float64
    input)."""
    mean = jnp.mean(x, axis=(1, 2), keepdims=True)
    centered = x - mean
    inv = jax.lax.rsqrt(jnp.mean(jnp.square(centered), axis=(1, 2), keepdims=True) + 1e-5)
    out = centered * inv
    return (jnp.maximum(out, 0) if relu else out), mean, inv


def _in_bwd_f64(x, mean, inv, g, relu):
    """The package's closed-form instance-norm backward in the input's dtype."""
    centered = x - mean
    gp = jnp.where(centered > 0, g, 0) if relu else g
    m1 = jnp.mean(gp, axis=(1, 2), keepdims=True)
    mgy = inv * jnp.mean(gp * centered, axis=(1, 2), keepdims=True)
    return inv * (gp - m1 - (centered * inv) * mgy)


@contextlib.contextmanager
def flax_float64(monkeypatch):
    """The JAX package in float64: x64 on, and its instance norm's float32
    statistics and backward replaced by the same formulas in the input's
    dtype.  Give it float64 variables (``to_f64``)."""
    with monkeypatch.context() as m:
        m.setattr(jnorm, "_jax_instance_norm_stats", _in_stats_f64)
        m.setattr(jnorm, "_xla_instance_norm_bwd", _in_bwd_f64)
        with jax.enable_x64(True):
            yield


def to_f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _parity(flax_module, torch_module, x, rng, atol, **kw):
    params, stats = _flax_vars(flax_module, x, rng, **kw)
    ref = _nchw(flax_module.apply(
        {"params": params, "batch_stats": stats}, _nhwc(x), **kw))
    torch_module.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = torch_module.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol)


# --------------------------------------------------------------------------
# functional layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["reflect_pad", "instance_norm",
                                  "instance_norm_relu", "avg_pool_3x3_s2"])
def test_functional_layer_matches_flax(rng, name):
    x = rng.standard_normal((2, 5, 9, 14)).astype(np.float32)
    if name == "reflect_pad":
        ref = _nchw(jlayers.reflect_pad(_nhwc(x), 3))
        got = tlayers.reflect_pad(torch.from_numpy(x), 3).numpy()
    else:
        ref = _nchw(getattr(jlayers, name)(_nhwc(x)))
        got = getattr(tlayers, name)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


_BLOCKS = {
    "interpolate_upsample": (
        lambda: jlayers.InterpolateUpsample(8, 4),
        lambda: tlayers.InterpolateUpsample(8, 4), (2, 8, 6, 10), {}),
    "conv_res_block": (
        lambda: jlayers.ConvResBlock(8, 16),
        lambda: tlayers.ConvResBlock(8, 16), (2, 8, 12, 16), {}),
    "resnet_block": (
        lambda: jlayers.ResnetBlock(8),
        lambda: tlayers.ResnetBlock(8), (2, 8, 10, 12), {}),
    "bottle_block_shortcut": (
        lambda: jattn.BottleBlock(16, (4, 8), proj_factor=4, heads=2, dim_head=4),
        lambda: tattn.BottleBlock(8, 16, (4, 8), proj_factor=4, heads=2, dim_head=4),
        (2, 8, 4, 8), {"train": False}),
    "bottle_stack": (
        lambda: jattn.BottleStack(16, (4, 8), num_layers=2, heads=2, dim_head=4),
        lambda: tattn.BottleStack(8, 16, (4, 8), num_layers=2, heads=2, dim_head=4),
        (2, 8, 4, 8), {"train": False}),
}


@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_block_matches_flax(rng, name):
    flax_f, torch_f, shape, kw = _BLOCKS[name]
    x = rng.standard_normal(shape).astype(np.float32)
    _parity(flax_f(), torch_f(), x, rng, atol=1e-4, **kw)


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

SMALL_LOCAL = dict(
    input_nc=2, output_nc=1, ngf=4, n_downsample_global=2, n_blocks_global=1,
    n_blocks_local=1, n_attn_global=1, input_size=(32, 64), heads_g=2,
    dim_head_g=4, downsample_type="resconv", upsample_type="interpolate",
)
SMALL_GLOBAL = dict(
    input_nc=2, output_nc=1, ngf=4, n_downsampling=2, n_blocks=2, n_attn=1,
    input_size=(32, 32), heads=2, dim_head=4, downsample_type="conv",
    upsample_type="interpolate",
)


def test_small_local_enhancer_matches_flax(rng):
    x = rng.standard_normal((2, 2, 32, 64)).astype(np.float32)
    _parity(jgen.LocalEnhancer(**SMALL_LOCAL), tgen.LocalEnhancer(**SMALL_LOCAL),
            x, rng, atol=5e-4, train=False)


@pytest.mark.parametrize("include_head", [True, False])
def test_small_global_generator_matches_flax(rng, include_head):
    x = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    cfg = dict(SMALL_GLOBAL, include_head=include_head)
    _parity(jgen.GlobalGenerator(**cfg), tgen.GlobalGenerator(**cfg), x, rng,
            atol=5e-4, train=False)


def test_flagship_local_enhancer_matches_flax(rng):
    """The shipped architecture at full width and geometry (ngf 56,
    128 x 256), batch 1."""
    torch_g = tgen.build_generator(flagship_opt())
    assert len(list(torch_g.parameters())) == 115
    assert len(list(torch_g.buffers())) == 18
    x = rng.standard_normal((1, 2, 128, 256)).astype(np.float32)
    _parity(flagship_generator(), torch_g, x, rng, atol=5e-4, train=False)


def test_unported_generator_options_raise():
    """The pixelshuffle upsample is still refused.  Local attention and
    several enhancers build now (``test_local_layout_matches_flax``)."""
    with pytest.raises(NotImplementedError):
        tgen.build_generator(dict(SMALL_LOCAL, netG="local", upsample_type="pixelshuffle"))
    g = tgen.build_generator(dict(netG="local", n_blocks_attn_l=1, n_local_enhancers=2,
                                  upsample_type="interpolate", heads_l=3, dim_head_l=8,
                                  proj_factor_l=2))
    assert g.n_attn_local == 1 and g.prefixes == ["enh1_", ""]
    assert (g.enh1_local_attn.block0.attn.heads, g.local_attn.block0.attn.dim_head) == (3, 8)


def port_local_kwargs(cfg):
    """``LocalEnhancer`` arguments from a configuration of
    ``tests/test_import_gold.py``."""
    return dict(
        n_local_enhancers=cfg.get("n_local_enhancers", 1), input_nc=cfg["input_nc"],
        output_nc=cfg["output_nc"], ngf=cfg["ngf"],
        n_downsample_global=cfg["n_downsample_global"],
        n_blocks_global=cfg["n_blocks_global"], n_blocks_local=cfg["n_blocks_local"],
        n_attn_global=cfg["n_attn_g"], n_attn_local=cfg["n_attn_l"],
        input_size=cfg["input_size"], proj_factor_g=cfg["proj_factor_g"],
        heads_g=cfg["heads_g"], dim_head_g=cfg["dim_head_g"],
        proj_factor_l=cfg["proj_factor_l"], heads_l=cfg["heads_l"],
        dim_head_l=cfg["dim_head_l"], downsample_type=cfg["downsample_type"],
        upsample_type=cfg["upsample_type"])


# the reference's layouts with local attention and several enhancers, plus
# three enhancers (without local attention: at three levels the coarsest
# branch's attention runs on a 2x2 map, where the Flax float32 output alone
# is several 1e-4 from float64)
LOCAL_LAYOUTS = {
    "both_attn": SMALL_LOCAL_BOTH_ATTN,
    "n2": SMALL_LOCAL_N2,
    "attn_only": SMALL_LOCAL_ATTN_ONLY,
    "n3": dict(SMALL_LOCAL_N2, n_local_enhancers=3, n_attn_l=0, input_size=(64, 64)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layout", sorted(LOCAL_LAYOUTS))
def test_local_layout_matches_flax(rng, monkeypatch, layout, train):
    """Local attention (the shared down and up stages, one set of weights
    each) and several enhancer branches against Flax: in eval mode, and in
    train mode with a ``sample_mask`` (the BatchNorm statistics of the real
    rows, and the running statistics they move to, 1e-5).

    The truth is the Flax module in float64 (``flax_float64``).  The port
    in float64 is held to it at 1e-6, which no layout error survives
    (measured 1.4e-7 to 1.7e-7: the head's tanh runs on float32 in Flax).
    The port's float32 is held within the larger of 5e-4 and 2x Flax's own
    float32 distance from the truth, and to Flax's float32 at 5e-4 plus
    that distance.  On this draw the both-attention layout is
    ill-conditioned in eval mode: Flax's float32 output is 3.2e-3 from the
    truth and the port's 1.1e-3; every other case has both under 1e-4."""
    cfg = LOCAL_LAYOUTS[layout]
    flax_g, port = jgen.LocalEnhancer(**port_local_kwargs(cfg)), \
        tgen.LocalEnhancer(**port_local_kwargs(cfg))
    x = rng.standard_normal((3, 2, *cfg["input_size"])).astype(np.float32)
    params, stats = _flax_vars(flax_g, x, rng, train=False)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    shared = [n for n in port.state_dict() if "_shared." in n]
    assert bool(shared) == (cfg["n_attn_l"] > 0)
    mask = np.array([1.0, 1.0, 0.0], np.float32)

    def flax_apply(variables, x, mask):
        if train:
            return flax_g.apply(variables, _nhwc(x), train=True, mutable=["batch_stats"],
                                sample_mask=jnp.asarray(mask))
        return flax_g.apply(variables, _nhwc(x), train=False), None

    ref, upd = jax.jit(flax_apply)({"params": params, "batch_stats": stats}, x, mask)
    with torch.no_grad():
        got = port.train(train)(torch.from_numpy(x), torch.from_numpy(mask))
    if train:
        moved = state_dict_from_jax(params, upd["batch_stats"])
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), moved[k].numpy(), atol=1e-5, err_msg=k)
    assert got.shape == _nchw(ref).shape == (3, 1, *cfg["input_size"])
    with flax_float64(monkeypatch):
        truth = _nchw(jax.jit(flax_apply)(to_f64({"params": params, "batch_stats": stats}),
                                          x.astype(np.float64), mask.astype(np.float64))[0])
    port64 = tgen.LocalEnhancer(**port_local_kwargs(cfg)).double()
    port64.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got64 = port64.train(train)(torch.from_numpy(x).double(),
                                    torch.from_numpy(mask).double()).numpy()
    np.testing.assert_allclose(got64, truth, atol=1e-6)
    flax_err = float(np.abs(_nchw(ref) - truth).max())
    assert float(np.abs(got.numpy() - truth).max()) <= max(5e-4, 2 * flax_err)
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=5e-4 + flax_err)


@pytest.mark.parametrize("layout", sorted(LOCAL_LAYOUTS))
def test_local_layout_dtypes_match_flax(rng, layout):
    """Under ``fp16`` every module of the new layouts returns the dtype of
    its Flax twin: the local attention's output float32, its shared stages
    and the enhancer branches bf16, the head float32."""
    from test_torch_bf16 import _flax_dtypes, _port_dtypes

    cfg = LOCAL_LAYOUTS[layout]
    flax_g = jgen.LocalEnhancer(**port_local_kwargs(cfg), dtype=jnp.bfloat16)
    port = tgen.LocalEnhancer(**port_local_kwargs(cfg), dtype=torch.bfloat16)
    x = rng.standard_normal((2, 2, *cfg["input_size"])).astype(np.float32)
    params, stats = _flax_vars(flax_g, x, rng, train=False)
    ref = _flax_dtypes(flax_g, {"params": params, "batch_stats": stats}, _nhwc(x), train=False)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    got = _port_dtypes(port.eval(), torch.from_numpy(x))
    assert set(got) <= set(ref), sorted(set(got) - set(ref))
    assert got == {k: ref[k] for k in got}
    assert got[""] == "float32"
    if cfg["n_attn_l"]:
        assert (got["local_attn"], got["local_attn_up_shared"]) == ("float32", "bfloat16")
    if cfg.get("n_local_enhancers", 1) > 1:
        assert got["enh1_local_up"] == "bfloat16"


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["small", "flagship"])
def test_state_dict_from_jax_equals_export_to_torch_keys(rng, which):
    """Strict load, and every tensor equals the reference exporter's under
    the rename flax path -> dotted port key."""
    if which == "small":
        flax_g, torch_g = jgen.LocalEnhancer(**SMALL_LOCAL), tgen.LocalEnhancer(**SMALL_LOCAL)
        x = np.zeros((1, 2, 32, 64), np.float32)
    else:
        flax_g, torch_g = flagship_generator(), tgen.build_generator(flagship_opt())
        x = np.zeros((1, 2, 128, 256), np.float32)
    params, stats = _flax_vars(flax_g, x, rng, train=False)
    sd = state_dict_from_jax(params, stats)
    torch_g.load_state_dict(sd, strict=True)
    exported = export_to_torch_keys(params, stats, generator_entries_for(flax_g))
    leaves = {"conv": ("weight", "bias"), "convT": ("weight", "bias"),
              "bn": ("weight", "bias", "running_mean", "running_var"),
              "posemb": ("height", "width")}
    seen = set()
    for prefix, path, kind in generator_entries_for(flax_g):
        for leaf in leaves[kind]:
            if f"{prefix}.{leaf}" not in exported:
                continue
            key = ".".join(path) + "." + leaf
            np.testing.assert_array_equal(sd[key].numpy(), exported[f"{prefix}.{leaf}"])
            seen.add(key)
    assert seen == set(sd)


def test_random_jax_trees_round_trip():
    """``random_jax_trees`` writes the Flax layout that
    ``state_dict_from_jax`` reads back into a strict load."""
    g = tgen.LocalEnhancer(**SMALL_LOCAL)
    params, stats = random_jax_trees(g, np.random.default_rng(3))
    assert params["global"]["stem"]["conv"]["kernel"].shape == (7, 7, 2, 8)
    assert set(stats["global"]["attn"]["block0"]["bn1"]["bn"]) == {"mean", "var"}
    sd = state_dict_from_jax(params, stats)
    g.load_state_dict(sd, strict=True)
    assert set(sd) == set(g.state_dict())


def test_init_weights_is_seeded():
    a, b = tgen.LocalEnhancer(**SMALL_LOCAL), tgen.LocalEnhancer(**SMALL_LOCAL)
    init_weights(a, torch.Generator().manual_seed(7))
    init_weights(b, torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    bn = a.coarse.attn.block0.bn1.bn
    assert torch.all(bn.running_var == 1) and abs(float(bn.weight.detach().mean()) - 1) < 0.05
