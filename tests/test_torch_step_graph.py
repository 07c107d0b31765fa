"""The train step's CUDA graphs (``train/step.py`` ``build_train_step``).

CPU cases: which calls the step would capture (``graph_key``), which
configurations draw noise, the step's counters off the card, and the eager
step against a plain restatement of its losses and update.

CUDA cases (marker ``cuda``; each skips without a card): graphed runs
against eager ones from the same seeded state on batches that differ step
by step, so a replay of a stale batch fails.  A ``train_step`` replays from
its second call of a key on; a fresh ``train_step`` for every call never
gets there, which is the eager run.  The small models of
``test_torch_cuda.py`` at batch 4, in bf16 (the flagship's ``--fp16``) and
in float32, where the card's own run-to-run spread is smaller.  This file
imports neither JAX nor the reference package:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py
"""

import functools
from typing import NamedTuple

import numpy as np
import pytest
import torch

from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.models.losses import feature_matching_loss, gan_loss
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform
from mdctgan_tpu_torch.options import spectral_config_from_opt
from mdctgan_tpu_torch.train import freeze
from mdctgan_tpu_torch.train.schedule import (
    OptimizerSpec, carry_schedule_count, make_optimizers)
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import (
    build_train_step, generator_forward, given_inputs, graph_key)
from mdctgan_tpu_torch.utils import tracing

OPT = dict(
    n_fft=128, hop_length=64, win_length=128, segment_length=8128, bins=128,
    netG="local", ngf=4, n_downsample_global=2, n_blocks_global=1,
    n_blocks_local=1, n_blocks_attn_g=1, heads_g=2, dim_head_g=4,
    downsample_type="resconv", upsample_type="interpolate",
    ndf=4, n_layers_D=2, num_D=2, fp16=True,
)
F32 = dict(OPT, fp16=False)
B = 4
MASK = [1.0, 1.0, 1.0, 0.0]
SGD = OptimizerSpec(functools.partial(torch.optim.SGD, lr=1.0))
COUNTERS = ("step.calls", "step.graph_captures", "step.graph_replays")
LR = 2e-4
# The largest gaps a graphed run may keep from the eager one (``gaps``), by
# precision.  The card does not repeat a backward pass bit for bit, so two
# eager runs differ too, and the small GAN from its random start amplifies
# that; so the limits sit between what two eager runs (or a graphed and an
# eager one) read on an H100 and what a stale batch (the captured one
# replayed) reads (PERF.md §6).  Largest spread seen: bf16 losses
# 0.0173, D's gradient 0.0154, G's statistics 8.1e-4; float32 0.0037,
# 0.0052, 6.4e-5, and G's gradient over the first three steps 0.048.  A
# stale batch: losses 0.24, D's gradient 0.12, statistics 2.2e-3 (bf16) and
# 2.9e-3 (float32), G's gradient 0.93 (float32).  bf16's G gradient drifts
# 0.06-0.5 apart between two eager runs within three steps: not compared.
TOLERANCE = {
    "bf16": dict(loss=6e-2, d_grad=4e-2, stats=1.4e-3),
    "f32": dict(loss=2e-2, d_grad=3e-2, stats=5e-4, g_grad=0.2),
}
PRECISIONS = {"bf16": OPT, "f32": F32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def counts():
    c = tracing.snapshot()
    return {k: c.get(k, 0) for k in COUNTERS}


def grown(before):
    now = counts()
    return {k: now[k] - before[k] for k in COUNTERS}


def batches(device, n, seed=0):
    """``n`` batches whose scale grows 1.6x a step, so no two give the
    same losses."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        hr = (0.05 * 1.6 ** i * rng.standard_normal((B, OPT["segment_length"])))
        lr = hr + 0.01 * rng.standard_normal(hr.shape)
        out.append({"lr_audio": torch.tensor(lr, dtype=torch.float32, device=device),
                    "hr_audio": torch.tensor(hr, dtype=torch.float32, device=device)})
    return out


def make_state(device, opt=OPT, accum=1, fix_global=False, seed=0):
    """The small G and D from seeded weights with their Adam optimizers;
    -> (state, G's spec, D's spec, G's unmasked spec)."""
    gen, disc = build_generator(opt), build_discriminator(opt)
    g_tx, d_tx = make_optimizers(LR, 0.5, 100, 100, 1000, accum_steps=accum)
    g_used = g_tx
    if fix_global:
        labels = freeze.param_labels([n for n, _ in gen.named_parameters()], fix_global=True)
        g_used = freeze.masked_optimizer(g_tx, labels)
    state = create_train_state(gen, disc, g_used, d_tx, device=device,
                               rng=torch.Generator().manual_seed(seed))
    return state, g_used, d_tx, g_tx


def new_step(device, g_tx, d_tx, use_pool=False):
    return build_train_step(SpectralTransform(spectral_config_from_opt(OPT), device), g_tx,
                            d_tx, n_layers_d=OPT["n_layers_D"], num_d=OPT["num_D"],
                            use_pool=use_pool)


def trajectory(device, calls, fresh, opt=OPT, accum=1, fix_global=False, carry_at=None):
    """The state stepped through ``calls`` (each a dict of the step's
    keyword inputs beside ``batch``), one ``train_step`` throughout or a
    fresh one for each call; G's optimizer unfrozen before call
    ``carry_at``.  -> (each step's losses, each step's ``.grad`` by leaf,
    G's buffers at the end, the counters' growth)."""
    state, g_tx, d_tx, g_full = make_state(device, opt, accum, fix_global)
    before = counts()
    step = new_step(device, g_tx, d_tx)
    losses, grads = [], []
    for i, call in enumerate(calls):
        if i == carry_at:
            state = carry_schedule_count(state, g_full)
        if fresh:
            step = new_step(device, g_tx, d_tx)
        state, metrics = step(state, **call)
        losses.append({k: float(v) for k, v in metrics.items()})
        grads.append({k: v.grad.cpu().clone() for k, v in leaves(state).items()
                      if v.grad is not None})
    stats = {k: v.detach().cpu().clone() for k, v in state.generator.named_buffers()}
    return losses, grads, stats, grown(before)


def leaves(state):
    return {**{f"G.{k}": v for k, v in state.generator.named_parameters()},
            **{f"D.{k}": v for k, v in state.discriminator.named_parameters()}}


def _net_gap(got, ref, net):
    keys = [k for k in ref if k.startswith(net + ".")]
    assert sorted(keys) == sorted(k for k in got if k.startswith(net + "."))
    a, b = (torch.cat([g[k].flatten() for k in keys]) for g in (got, ref))
    return float((a - b).norm() / b.norm())


def gaps(run, ref):
    """The largest gaps of ``run`` from ``ref``: each step's losses
    (relative), each step's whole gradient of D and of G over the first
    three steps (normwise relative), G's BatchNorm statistics at the end
    (absolute)."""
    (losses, grads, stats, _), (r_losses, r_grads, r_stats, _) = run, ref
    assert len(losses) == len(r_losses)
    return dict(
        loss=max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(losses, r_losses) for k in b),
        d_grad=max(_net_gap(a, b, "D") for a, b in zip(grads, r_grads)),
        g_grad=max(_net_gap(a, b, "G") for a, b in zip(grads[:3], r_grads[:3])),
        stats=max(float((stats[k] - r_stats[k]).abs().max()) for k in r_stats))


def assert_agree(graphed, eager, precision):
    got = gaps(graphed, eager)
    assert all(got[k] <= tol for k, tol in TOLERANCE[precision].items()), (precision, got)


# --------------------------------------------------------------------------
# CPU: the key's decisions, the counters off the card, the eager step
# --------------------------------------------------------------------------

class OnCard(NamedTuple):
    """What ``graph_key`` reads of an input: a card tensor's device, shape
    and dtype (there is no card here)."""
    shape: tuple
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")


def key_inputs(**over):
    given = {"lr_audio": OnCard((B, 64)), "hr_audio": OnCard((B, 64))}
    args = dict(ranks=None, draws=False, given=given, g_params=[torch.zeros(3)],
                d_params=[torch.zeros(2)])
    args.update(over)
    return args


@pytest.mark.parametrize("case, over", [
    ("cpu", dict(given={k: torch.zeros(B, 64) for k in ("lr_audio", "hr_audio")})),
    ("ranks", dict(ranks=object())),
    ("noise", dict(draws=True)),
])
def test_graph_key_chooses_eager(case, over):
    assert graph_key(**key_inputs()) is not None
    assert graph_key(**key_inputs(**over)) is None


def test_graph_key_is_the_same_for_the_same_shapes():
    args = key_inputs()
    again = {k: OnCard((B, 64)) for k in ("lr_audio", "hr_audio")}
    assert graph_key(**args) == graph_key(**dict(args, given=again))


@pytest.mark.parametrize("case", ["batch_shape", "batch_dtype", "sample_mask", "mask_shape",
                                  "pool", "g_params", "d_params"])
def test_graph_key_separates(case):
    args = key_inputs()
    base, masked = args["given"], dict(args["given"], sample_mask=OnCard((B,)))
    other = {
        "batch_shape": dict(given={k: OnCard((B - 1, 64)) for k in base}),
        "batch_dtype": dict(given={k: OnCard((B, 64), torch.float64) for k in base}),
        "sample_mask": dict(given=masked),
        "mask_shape": dict(given=dict(base, sample_mask=OnCard((B - 1,)))),
        "pool": dict(given=dict(base, pool_old=OnCard((B, 3, 8, 8)), pool_mask=OnCard((B,)))),
        "g_params": dict(g_params=args["g_params"] + [torch.zeros(1)]),
        "d_params": dict(d_params=[torch.zeros(2)]),
    }[case]
    assert graph_key(**args) != graph_key(**dict(args, **other))
    if case == "mask_shape":
        assert graph_key(**dict(args, given=masked)) != graph_key(**dict(args, **other))


def test_given_inputs_names_what_is_given():
    batch = {"lr_audio": torch.zeros(2), "hr_audio": torch.ones(2)}
    assert list(given_inputs(batch)) == ["lr_audio", "hr_audio"]
    mask = torch.ones(2)
    assert list(given_inputs(batch, sample_mask=mask)) == ["lr_audio", "hr_audio", "sample_mask"]
    assert given_inputs(batch, sample_mask=mask)["sample_mask"] is mask


@pytest.mark.parametrize("fields, draws", [
    (dict(), False),                                        # the flagship: no mask
    (dict(mask=True), False),                               # masked, fit_residual
    (dict(mask=True, fit_residual=False), True),
    (dict(mask_hr=True, fit_residual=False, sr_sampling_rate=24000), True),
    (dict(mask_hr=True, fit_residual=False), False),        # nothing masked at HR
    (dict(fit_residual=False), False),
])
def test_which_configurations_draw_noise(fields, draws):
    cfg = SpectralConfig(n_fft=128, hop_length=64, win_length=128, segment_length=8128,
                         **fields)
    assert SpectralTransform(cfg, "cpu").draws() is draws


def test_cpu_steps_stay_eager_and_count():
    """Off the card every call is eager: calls counted, nothing captured or
    replayed, the parts marked in order on every call."""
    cpu = torch.device("cpu")
    state, g_tx, d_tx, _ = make_state(cpu)
    step = new_step(cpu, g_tx, d_tx)
    before, marks = counts(), []
    for batch in batches(cpu, 3):
        state, _ = step(state, batch, mark=marks.append)
    assert grown(before) == {"step.calls": 3, "step.graph_captures": 0,
                             "step.graph_replays": 0}
    assert marks == ["k1", "g_forward", "d_forward", "backward", "optimizer"] * 3
    assert state.step == 3


def test_cpu_eager_step_matches_its_plain_statement():
    """One float32 SGD(1) step (the update is the gradient) against the
    module docstring's losses, written out with D called apart on fake and
    real."""
    cpu = torch.device("cpu")
    gen, disc = build_generator(F32), build_discriminator(F32)
    state = create_train_state(gen, disc, SGD, SGD, device=cpu,
                               rng=torch.Generator().manual_seed(3))
    start = {k: v.detach().clone() for k, v in leaves(state).items()}
    transform = SpectralTransform(spectral_config_from_opt(OPT), cpu)
    batch = batches(cpu, 1, seed=5)[0]

    with torch.no_grad():
        lr_spec = transform.lr_forward(batch["lr_audio"])[0]
        hr_spec = transform.hr_forward(batch["hr_audio"])[0]
    sr_spec = generator_forward(gen, transform, lr_spec)
    fake = torch.cat((lr_spec, transform.g_input(sr_spec)), dim=1)
    real = torch.cat((lr_spec, transform.g_input(hr_spec)), dim=1)
    frozen = {k: v.detach() for k, v in disc.named_parameters()}
    pred_fake_g = torch.func.functional_call(disc, frozen, (fake,))
    pred_fake_d, pred_real = disc(fake.detach()), disc(real)
    n_layers, num_d = OPT["n_layers_D"], OPT["num_D"]
    loss_g = (gan_loss(pred_fake_g, True)
              + feature_matching_loss(pred_fake_g, pred_real, n_layers, num_d, 10.0))
    loss_d = 0.5 * (gan_loss(pred_fake_d, False) + gan_loss(pred_real, True))
    names = list(leaves(state))
    grads = dict(zip(names, torch.autograd.grad(loss_g + loss_d, list(leaves(state).values()))))

    # the step from the same weights, G's BatchNorm statistics not yet moved
    state = create_train_state(build_generator(F32), build_discriminator(F32), SGD, SGD,
                               device=cpu, rng=torch.Generator().manual_seed(3))
    step = build_train_step(transform, SGD, SGD, n_layers_d=n_layers, num_d=num_d)
    state, metrics = step(state, batch)
    assert float(metrics["loss_G"]) == pytest.approx(float(loss_g.detach()), rel=1e-5)
    assert float(metrics["loss_D"]) == pytest.approx(float(loss_d.detach()), rel=1e-5)
    for k, v in leaves(state).items():
        update = start[k] - v.detach()
        err = float((update - grads[k]).norm())
        assert err <= 1e-4 * float(grads[k].norm()) + 1e-7, k


# --------------------------------------------------------------------------
# CUDA: graphed against eager
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_graphed_steps_match_eager(cuda, precision):
    """Six steps on six batches: the first eager, the second captured and
    replayed, four replayed; K1 twice a step either way."""
    calls = [{"batch": b} for b in batches(cuda, 6)]
    K.reset_launch_counts()
    graphed = trajectory(cuda, calls, fresh=False, opt=PRECISIONS[precision])
    launches = dict(K.LAUNCHES)
    K.reset_launch_counts()
    eager = trajectory(cuda, calls, fresh=True, opt=PRECISIONS[precision])
    assert graphed[-1] == {"step.calls": 6, "step.graph_captures": 1, "step.graph_replays": 5}
    assert eager[-1] == {"step.calls": 6, "step.graph_captures": 0, "step.graph_replays": 0}
    assert launches == dict(K.LAUNCHES) == {"mdct_spectro": 12, "imdct_audio": 0,
                                             "mdct_spectro_dense": 0, "imdct_audio_dense": 0}
    assert_agree(graphed, eager, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_unfreeze_captures_anew(cuda, precision):
    """G's optimizer unfrozen (``carry_schedule_count``) after two steps:
    more parameters, a new key, so one more eager call and one more
    capture (replays: the second step, then the fourth to the sixth)."""
    calls = [{"batch": b} for b in batches(cuda, 6, seed=1)]
    kw = dict(opt=PRECISIONS[precision], fix_global=True, carry_at=2)
    graphed = trajectory(cuda, calls, fresh=False, **kw)
    eager = trajectory(cuda, calls, fresh=True, **kw)
    assert graphed[-1] == {"step.calls": 6, "step.graph_captures": 2, "step.graph_replays": 4}
    assert_agree(graphed, eager, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_padded_tail_batch_captures_its_own_graphs(cuda, precision):
    """Three full batches, then three under a sample mask (a padded tail):
    each kind eager once, then captured and replayed."""
    mask = torch.tensor(MASK, device=cuda)
    calls = [{"batch": b, "sample_mask": mask if i >= 3 else None}
             for i, b in enumerate(batches(cuda, 6, seed=2))]
    graphed = trajectory(cuda, calls, fresh=False, opt=PRECISIONS[precision])
    eager = trajectory(cuda, calls, fresh=True, opt=PRECISIONS[precision])
    assert graphed[-1] == {"step.calls": 6, "step.graph_captures": 2, "step.graph_replays": 4}
    assert_agree(graphed, eager, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_accumulation_over_replays(cuda, precision):
    """``accum_steps`` 2: a window's first micro-batch keeps a copy of the
    graph's gradients, which the second one's replay overwrites."""
    calls = [{"batch": b} for b in batches(cuda, 6, seed=3)]
    graphed = trajectory(cuda, calls, fresh=False, opt=PRECISIONS[precision], accum=2)
    eager = trajectory(cuda, calls, fresh=True, opt=PRECISIONS[precision], accum=2)
    assert graphed[-1]["step.graph_replays"] == 5
    assert_agree(graphed, eager, precision)


@pytest.mark.cuda
def test_a_stale_batch_is_caught(cuda):
    """What the comparison would read if every replay ran the captured
    batch: the second batch again and again, against the six batches."""
    calls = [{"batch": b} for b in batches(cuda, 6)]
    stale = trajectory(cuda, calls[:1] + calls[1:2] * 5, fresh=True, opt=F32)
    eager = trajectory(cuda, calls, fresh=True, opt=F32)
    got = gaps(stale, eager)
    assert all(got[k] > 2 * tol for k, tol in TOLERANCE["f32"].items()), got
    assert all(got[k] > tol for k, tol in TOLERANCE["bf16"].items()), got


@pytest.mark.cuda
def test_returned_metrics_outlive_the_next_step(cuda):
    """A step's metrics and its ``fake_concat`` (the image pool's input)
    read the same after later replays as when they were returned."""
    state, g_tx, d_tx, _ = make_state(cuda)
    step = new_step(cuda, g_tx, d_tx, use_pool=True)
    rng = torch.Generator().manual_seed(4)
    before = counts()
    held, seen = [], []
    for batch in batches(cuda, 5, seed=4):
        pool_old = torch.randn(B, 3, OPT["bins"], OPT["n_fft"] // 2, generator=rng).to(cuda)
        pool_mask = torch.tensor([1.0, 0.0, 1.0, 0.0], device=cuda)
        state, metrics = step(state, batch, pool_old=pool_old, pool_mask=pool_mask)
        held.append(metrics)
        seen.append({k: v.detach().cpu().clone() for k, v in metrics.items()})
    assert grown(before)["step.graph_replays"] == 4
    for metrics, first in zip(held, seen):
        for k, v in first.items():
            assert torch.equal(metrics[k].cpu(), v), k
    assert float(held[-1]["loss_G"]) != float(held[-2]["loss_G"])
