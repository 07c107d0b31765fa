"""The port's layers, attention and generators against the Flax reference
(eval mode) on the same seeded weights, carried by
``weights.state_dict_from_jax``.  CPU, float32, absolute bounds."""

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
from mdctgan_tpu.train.import_torch import export_to_torch_keys, generator_entries_for

from mdctgan_tpu_torch.configs import flagship_opt
from mdctgan_tpu_torch.models import attention as tattn
from mdctgan_tpu_torch.models import generator as tgen
from mdctgan_tpu_torch.models import layers as tlayers
from mdctgan_tpu_torch.weights import init_weights, random_jax_trees, state_dict_from_jax


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
    with pytest.raises(NotImplementedError):
        tgen.build_generator(dict(SMALL_LOCAL, netG="local", upsample_type="pixelshuffle"))
    with pytest.raises(NotImplementedError):
        tgen.build_generator(dict(netG="local", n_blocks_attn_l=1,
                                  upsample_type="interpolate"))
    with pytest.raises(NotImplementedError):
        tgen.build_generator(dict(netG="local", n_local_enhancers=2,
                                  upsample_type="interpolate"))


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
