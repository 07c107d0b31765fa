"""The bf16 networks' channels-last activations (``models/layers.py``
``conv_nhwc``, ``conv_layout``, ``reflect_pad``, ``reduce_mean``; the
attention's NHWC views; the counters ``conv.bf16_calls`` and
``conv.nhwc_in``).

On the card a bf16 network holds its activations channels-last; float32
and the CPU keep NCHW.  The rule is turned on for the CPU here by standing
in for it, and the NHWC path is held to the NCHW one: against a float64
truth within the bound ``tests/test_torch_bf16.py`` uses (twice the
reference's error, by max and by RMS), in outputs and in every parameter's
gradient; every convolution's input arrives channels-last; the float32
path runs the same ops, bit for bit; the gradients reach the optimizer in
their parameters' layout and the checkpoints hold the same tensors."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from mdctgan_tpu_torch.models import layers
from mdctgan_tpu_torch.models.attention import Attention2D, _BN2d
from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.options import spectral_config_from_opt
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager, snapshot, state_digest
from mdctgan_tpu_torch.train.schedule import make_optimizers
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_train_step
from mdctgan_tpu_torch.utils import tracing
from mdctgan_tpu_torch.weights import init_weights

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
CL = torch.channels_last
BF16 = torch.bfloat16
SPECTRAL = dict(n_fft=128, hop_length=64, win_length=128, segment_length=8128, bins=128)
GENERATORS = {
    # the flagship's layout at a small width: resconv down, interpolate up, attention
    "local": dict(SPECTRAL, netG="local", ngf=8, n_downsample_global=2, n_blocks_global=2,
                  n_blocks_local=1, n_blocks_attn_g=1, heads_g=2, dim_head_g=4,
                  downsample_type="resconv", upsample_type="interpolate"),
    # strided conv down, transposed conv up
    "global": dict(SPECTRAL, netG="global", ngf=8, n_downsample_global=2, n_blocks_global=1,
                   n_blocks_attn_g=1, heads_g=2, dim_head_g=4, downsample_type="conv",
                   upsample_type="transconv"),
}
D_OPT = dict(ndf=8, n_layers_D=2, num_D=2)


@pytest.fixture
def fresh_counters(monkeypatch):
    monkeypatch.setattr(tracing, "COUNTERS", {})


def _rule_on_cpu(monkeypatch):
    """The card's rule, standing in on the CPU: bf16 networks channels-last."""
    monkeypatch.setattr(layers, "conv_nhwc", lambda dtype, device: dtype == BF16)


def _rng(seed):
    return torch.Generator().manual_seed(seed)


def _nets(opt, fp16=True):
    opt = dict(opt, **D_OPT, fp16=fp16)
    g, d = build_generator(opt), build_discriminator(opt)
    init_weights(g, _rng(3))
    init_weights(d, _rng(4))
    return g.train(), d.train()


def _inputs(batch=3):
    x = torch.randn(batch, 2, 128, 64, generator=_rng(1))
    return x, torch.randn(batch, 1, 128, 64, generator=_rng(2))


def _forward_backward(g, d, x, r, dtype=None):
    """G's output, D's logit maps on (x, G(x)) and every parameter's
    gradient of a loss of both."""
    if dtype is not None:
        g, d, x, r = g.to(dtype), d.to(dtype), x.to(dtype), r.to(dtype)
    g.zero_grad(set_to_none=True)
    d.zero_grad(set_to_none=True)
    out = g(x)
    feats = d(torch.cat((x, out), dim=1))
    loss = (out * r).sum() + sum(layers.lift(f[-1]).square().mean() for f in feats)
    loss.backward()
    grads = {f"G.{n}": p.grad.clone() for n, p in g.named_parameters()}
    grads.update({f"D.{n}": p.grad.clone() for n, p in d.named_parameters()})
    return out.detach(), [layers.lift(f[-1]).detach() for f in feats], grads


def _errors(got, truth):
    diff = got.double() - truth
    return float(diff.abs().max()), float(diff.square().mean().sqrt())


def _within(got, ref, truth, label, factor=2.0):
    """``tests/test_torch_bf16.py``'s bound: the NHWC error against the
    float64 truth at most ``factor`` times the NCHW error, by max and RMS
    (both exact, 0, only where both are)."""
    p, r = _errors(got, truth), _errors(ref, truth)
    for mine, theirs in zip(p, r):
        assert mine <= factor * theirs or mine == theirs == 0.0, (
            f"{label}: NHWC max {p[0]:.3e} RMS {p[1]:.3e}, NCHW max {r[0]:.3e} RMS {r[1]:.3e}")


def _block(name):
    """A gradient's top-level block (``tests/test_torch_bf16.py``'s
    pooling): each global stage, each enhancer stage, each discriminator
    layer."""
    net, parts = name[:1], name[2:].split(".")
    return net + "." + (".".join(parts[:2]) if parts[0] == "global" or
                        parts[0].startswith("scale") else parts[0])


# --------------------------------------------------------------------------
# the rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,device,nhwc", [
    (BF16, CUDA, True),
    (BF16, torch.device("cuda", 1), True),
    (torch.float32, CUDA, False),
    (None, CUDA, False),
    (torch.float16, CUDA, False),
    (torch.float64, CUDA, False),
    (BF16, CPU, False),
    (torch.float32, CPU, False),
    (None, CPU, False),
])
def test_conv_nhwc_is_bf16_on_the_card(dtype, device, nhwc):
    assert layers.conv_nhwc(dtype, device) is nhwc


@pytest.mark.parametrize("dtype", [None, torch.float32, BF16])
def test_conv_layout_leaves_the_cpu_as_it_is(dtype):
    x = torch.randn(2, 5, 4, 6)
    assert layers.conv_layout(x, dtype) is x


def test_conv_layout_under_the_rule(monkeypatch):
    _rule_on_cpu(monkeypatch)
    x = torch.randn(2, 5, 4, 6)
    y = layers.conv_layout(x, BF16)
    assert layers.channels_last(y) and torch.equal(y, x) and y.dtype == x.dtype
    assert layers.conv_layout(y, BF16) is y  # once at the entry
    assert layers.conv_layout(x, None) is x and layers.conv_layout(x, torch.float32) is x


# --------------------------------------------------------------------------
# the ops between the convolutions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_reflect_pad_keeps_channels_last(pad, dtype):
    """The channels-last form pads the same elements as ``F.pad`` and
    returns channels-last; its gradient is the 2-D pad's, channels-last."""
    x = torch.randn(2, 6, 9, 11, generator=_rng(pad)).to(dtype)
    r = torch.randn(2, 6, 9 + 2 * pad, 11 + 2 * pad, generator=_rng(7)).to(dtype)
    want = F.pad(x, (pad,) * 4, mode="reflect")
    xc = x.contiguous(memory_format=CL).requires_grad_()
    got = layers.reflect_pad(xc, pad)
    assert layers.channels_last(got) and torch.equal(got, want)
    g, = torch.autograd.grad(got, xc, r.contiguous(memory_format=CL))
    x.requires_grad_()
    want_g, = torch.autograd.grad(F.pad(x, (pad,) * 4, mode="reflect"), x, r)
    assert layers.channels_last(g)
    torch.testing.assert_close(g, want_g, rtol=0, atol=0)


@pytest.mark.parametrize("dim,keepdim,dtype", [
    ((2, 3), True, torch.float32),  # the instance norm's means of a bf16 map
    ((0, 2, 3), False, None),  # the BatchNorm's
    (None, False, None),  # a loss's
])
def test_reduce_mean_gradient_stays_channels_last(dim, keepdim, dtype):
    """``reduce_mean`` on a channels-last tensor: autograd's value and
    gradient, bit for bit, and a gradient that does not leave the layout
    in the op that uses it."""
    src = BF16 if dtype is not None else torch.float32
    x = torch.randn(3, 8, 5, 7, generator=_rng(0)).to(src).contiguous(memory_format=CL)
    w = torch.randn(3, 8, 5, 7, generator=_rng(1)).to(src).contiguous(memory_format=CL)

    def run(mean):
        xx = x.detach().requires_grad_()
        m = mean(xx)
        y = (xx - (m.reshape(-1, 1, 1) if m.dim() == 1 else m).to(src)) * w
        g, = torch.autograd.grad((layers.lift(y).square().sum()), xx)
        return m, g

    if dim is None:
        want_m, want_g = run(lambda t: t.mean(dtype=dtype))
    else:
        want_m, want_g = run(lambda t: t.mean(dim=dim, keepdim=keepdim, dtype=dtype))
    got_m, got_g = run(lambda t: layers.reduce_mean(t, dim, keepdim, dtype))
    assert torch.equal(got_m, want_m)
    torch.testing.assert_close(got_g, want_g, rtol=0, atol=0)
    assert layers.channels_last(got_g)


def test_reduce_mean_is_the_plain_mean_off_channels_last():
    """An NCHW tensor, or one autograd does not record, takes the plain
    ``Tensor.mean``: no function of the port's in its graph."""
    x = torch.randn(2, 4, 3, 5, requires_grad=True)
    assert type(layers.reduce_mean(x, (2, 3), True).grad_fn).__name__ == "MeanBackward1"
    assert type(layers.reduce_mean(x).grad_fn).__name__ == "MeanBackward0"
    with torch.no_grad():
        y = layers.reduce_mean(x.contiguous(memory_format=CL), (2, 3), True)
    assert y.grad_fn is None


def test_attention_views_over_channels_last_bytes():
    """The attention's NHWC views give the NCHW path's output, laid out
    channels-last; an NCHW input keeps the NCHW path."""
    torch.manual_seed(0)
    attn = Attention2D(16, (4, 6), heads=2, dim_head=8)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(2, 16, 4, 6, generator=_rng(5))
    want = attn(x)
    got = attn(x.contiguous(memory_format=CL))
    assert layers.channels_last(got) and want.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_batchnorm_on_channels_last_matches():
    """The attention stack's BatchNorm on a channels-last map: the NCHW
    map's output and input gradient (float32, to summation order), both
    channels-last."""
    bn = _BN2d(6).train()
    x = torch.randn(4, 6, 5, 7, generator=_rng(2))
    r = torch.randn(4, 6, 5, 7, generator=_rng(3))
    grads = []
    for fmt in (torch.contiguous_format, CL):
        t = x.contiguous(memory_format=fmt).requires_grad_()
        y = bn(t)
        grads.append((y, torch.autograd.grad(y, t, r.contiguous(memory_format=fmt))[0]))
    (want, want_g), (got, got_g) = grads
    assert layers.channels_last(got) and layers.channels_last(got_g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the networks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_bf16_networks_channels_last_match_nchw(monkeypatch, fresh_counters, name):
    """bf16 G and the multiscale D with the rule on: outputs, logit maps
    and every parameter's gradient within the bf16 bound of the NCHW path,
    against the same networks in float64; every activation channels-last
    and every convolution's input arriving so."""
    g, d = _nets(GENERATORS[name])
    x, r = _inputs()
    want = _forward_backward(g, d, x, r)
    assert tracing.COUNTERS == {}  # off the card the rule is off
    g64, d64 = _nets(GENERATORS[name], fp16=False)
    g64.load_state_dict(g.state_dict())
    d64.load_state_dict(d.state_dict())
    truth = _forward_backward(g64, d64, x, r, torch.float64)

    _rule_on_cpu(monkeypatch)
    seen, convs = [], []
    hooks = [m.register_forward_hook(lambda m, a, out: seen.append(out))
             for m in list(g.modules()) + list(d.modules()) if isinstance(m, layers.Conv)]
    for name_ in ("conv2d", "conv_transpose2d"):
        def counted(t, *args, _op=getattr(F, name_), **kw):
            convs.append(t)
            return _op(t, *args, **kw)
        monkeypatch.setattr(F, name_, counted)
    got = _forward_backward(g, d, x, r)
    for h in hooks:
        h.remove()
    assert seen and all(layers.channels_last(y) or y.shape[1] == 1 for y in seen)
    assert all(t.is_contiguous(memory_format=CL) for t in convs)
    assert tracing.COUNTERS == {"conv.bf16_calls": len(convs), "conv.nhwc_in": len(convs)}

    _within(got[0], want[0], truth[0], "G output")
    for i, (a, b, t) in enumerate(zip(got[1], want[1], truth[1])):
        _within(a, b, t, f"D scale {i} logits")
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        assert got[2][k].stride() == want[2][k].stride(), k
    for block in sorted({_block(k) for k in want[2]}):
        _within(*(torch.cat([run[2][k].ravel() for k in run[2] if _block(k) == block])
                  for run in (got, want, truth)), block)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_pyramids_pool_nchw(monkeypatch, name):
    """Under the rule the average-pool pyramids of G and D pool NCHW maps
    (the card's channels-last pool returns a wrong gradient) and each level
    enters its network channels-last."""
    _rule_on_cpu(monkeypatch)
    pooled = []

    def pool(x):
        pooled.append(layers.channels_last(x))
        return layers.avg_pool_3x3_s2(x)

    from mdctgan_tpu_torch.models import discriminator, generator
    monkeypatch.setattr(discriminator, "avg_pool_3x3_s2", pool)
    monkeypatch.setattr(generator, "avg_pool_3x3_s2", pool)
    g, d = _nets(GENERATORS[name])
    x, r = _inputs()
    _forward_backward(g, d, x, r)
    levels = len(g.prefixes) if name == "local" else 0
    assert pooled == [False] * (levels + D_OPT["num_D"] - 1)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_float32_networks_run_the_same_ops_bit_for_bit(monkeypatch, fresh_counters, name):
    """With the rule on, the float32 networks run the very ops they ran
    before, in the same order, to the same bits: no layout, no counter."""

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    g, d = _nets(GENERATORS[name], fp16=False)
    x, r = _inputs()
    runs = []
    for on in (False, True):
        if on:
            _rule_on_cpu(monkeypatch)
        with Ops() as ops:
            out, logits, grads = _forward_backward(g, d, x, r)
        runs.append((ops.names, out, logits, grads))
    (names0, out0, logits0, grads0), (names1, out1, logits1, grads1) = runs
    assert names0 == names1 and len(names0) > 100
    assert torch.equal(out0, out1)
    assert all(torch.equal(a, b) for a, b in zip(logits0, logits1))
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)
    assert tracing.COUNTERS == {}


def test_conv_forward_counts_what_arrives(monkeypatch, fresh_counters):
    """Under the rule each bf16 convolution counts once, and once more
    where its input arrived channels-last; the output is channels-last
    either way, and its weight's gradient contiguous float32."""
    _rule_on_cpu(monkeypatch)
    first, second = torch.nn.Conv2d(6, 8, 3, padding=1), torch.nn.ConvTranspose2d(8, 4, 3, 2, 1, 1)
    x = torch.randn(2, 6, 5, 7, generator=_rng(0))
    y = layers.conv_forward(first, x, BF16)
    assert tracing.COUNTERS == {"conv.bf16_calls": 1}
    assert y.dtype == BF16 and layers.channels_last(y)
    z = layers.conv_forward(second, y, BF16)
    assert tracing.COUNTERS == {"conv.bf16_calls": 2, "conv.nhwc_in": 1}
    assert z.shape == (2, 4, 10, 14) and layers.channels_last(z)
    layers.lift(z).square().sum().backward()
    for conv in (first, second):
        for p in conv.parameters():
            assert p.grad.dtype == torch.float32 and p.grad.stride() == p.stride()


# --------------------------------------------------------------------------
# the train step, the optimizer and the checkpoints
# --------------------------------------------------------------------------

def _state():
    opt = dict(GENERATORS["local"], **D_OPT, fp16=True)
    g_tx, d_tx = make_optimizers(2e-4, 0.5, 1, 1, 10)
    state = create_train_state(build_generator(opt), build_discriminator(opt), g_tx, d_tx,
                               device="cpu", rng=_rng(0))
    step = build_train_step(SpectralTransform(spectral_config_from_opt(opt), "cpu"), g_tx, d_tx,
                            n_layers_d=2, num_d=2)
    x = torch.from_numpy(0.1 * np.random.default_rng(0).standard_normal((2, 8128))).float()
    return state, step, {"lr_audio": x, "hr_audio": x.flip(1).contiguous()}


def test_train_step_feeds_the_optimizer_its_parameters_layout(monkeypatch, fresh_counters):
    """A bf16 train step under the rule: every convolution's input arrives
    channels-last, each gradient the optimizer reads and each moment it
    keeps has its parameter's layout (contiguous), so ``torch._foreach_*``
    keeps its multi-tensor path."""
    _rule_on_cpu(monkeypatch)
    state, step, batch = _state()
    for _ in range(2):
        state, metrics = step(state, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    calls = tracing.COUNTERS["conv.bf16_calls"]
    assert calls > 0 and tracing.COUNTERS["conv.nhwc_in"] == calls
    for module, opt in ((state.generator, state.g_opt), (state.discriminator, state.d_opt)):
        for p in module.parameters():
            assert p.is_contiguous() and p.grad.stride() == p.stride()
            moments = opt.state[p]
            assert moments["exp_avg"].stride() == moments["exp_avg_sq"].stride() == p.stride()


def test_checkpoints_hold_the_nchw_tensors(monkeypatch, tmp_path):
    """The parameters stay NCHW under the rule: a fresh state's save is
    the NCHW model's, bit for bit, and a save after steps holds the live
    tensors, contiguous, at the NCHW model's shapes."""
    nchw, _, _ = _state()
    _rule_on_cpu(monkeypatch)
    state, step, batch = _state()
    assert state_digest(state) == state_digest(nchw)
    state, _ = step(state, batch)
    manager = CheckpointManager(str(tmp_path))
    manager.save(state, epoch=1)
    manager.wait()
    saved = torch.load(manager._path(1), map_location="cpu", weights_only=True)["state"]
    for key, module in (("generator", state.generator), ("discriminator", state.discriminator)):
        live, shapes = module.state_dict(), getattr(nchw, key).state_dict()
        assert saved[key].keys() == live.keys() == shapes.keys()
        for name, t in saved[key].items():
            assert t.is_contiguous() and t.shape == shapes[name].shape, name
            assert torch.equal(t, live[name]), name
    assert state_digest(snapshot(state)) == state_digest(state)


# --------------------------------------------------------------------------
# CUDA (marker ``cuda``; skips without a card):
#     python -m pytest --noconftest -m cuda tests/test_torch_channels_last.py
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _transposes(cuda, g, d):
    """cuDNN's layout transposes launched in one forward and backward of
    G and D on the card (after one to warm cuDNN up)."""
    x, r = (t.to(cuda) for t in _inputs())
    _forward_backward(g, d, x, r)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _forward_backward(g, d, x, r)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "nchwToNhwc" in e.name or "nhwcToNchw" in e.name)


@pytest.mark.cuda
def test_the_card_gives_d_its_input_gradient(cuda, monkeypatch):
    """On the card the bf16 multiscale D's gradient with respect to its
    input, rule on, is within twice the NCHW path's error against float64
    (``chip_smoke.py`` phase 8b's bound).  The card's channels-last average
    pool returns a wrong gradient (torch 2.11 cu128), which the NCHW
    pyramid keeps out."""
    _, d = _nets(GENERATORS["local"])
    d64 = build_discriminator(dict(GENERATORS["local"], **D_OPT))
    d64.load_state_dict(d.state_dict())
    x = torch.randn(4, 3, 128, 256, generator=_rng(8))  # the flagship's D input, at batch 4

    def input_grad(net, dtype):
        xx = x.to(cuda, dtype).requires_grad_()
        loss = sum(layers.lift(f).square().mean() for scale in net.to(cuda)(xx) for f in scale)
        return torch.autograd.grad(loss, xx)[0].double()

    truth = input_grad(d64.double(), torch.float64)
    nhwc = input_grad(d, torch.float32)
    monkeypatch.setattr(layers, "conv_nhwc", lambda dtype, device: False)
    nchw = input_grad(d, torch.float32)
    err = [float((g - truth).norm()) for g in (nhwc, nchw)]
    assert err[0] <= 2.0 * err[1], err


@pytest.mark.cuda
def test_the_card_feeds_cudnn_nhwc(cuda, monkeypatch, fresh_counters):
    """On the card, under the rule itself: the bf16 networks feed every
    convolution channels-last and launch a fifth or less of the transposes
    the NCHW layout does (the 2- and 3-channel inputs may keep some); the
    float32 networks count nothing."""
    g, d = (m.to(cuda) for m in _nets(GENERATORS["local"]))
    nhwc = _transposes(cuda, g, d)
    c = dict(tracing.COUNTERS)
    assert c["conv.bf16_calls"] > 0 and c["conv.nhwc_in"] == c["conv.bf16_calls"]
    monkeypatch.setattr(layers, "conv_nhwc", lambda dtype, device: False)
    nchw = _transposes(cuda, g, d)
    assert nchw > 0 and 5 * nhwc <= nchw, (nhwc, nchw)
    monkeypatch.undo()
    monkeypatch.setattr(tracing, "COUNTERS", {})
    g32, d32 = (m.to(cuda) for m in _nets(GENERATORS["local"], fp16=False))
    _transposes(cuda, g32, d32)
    assert tracing.COUNTERS == {}
