"""The GAN train step and the serving forward: the port of
``mdctgan_tpu/train/step.py``.

Per step (``build_train_step``):

  * loss_D = 0.5 * (LSGAN(D(lr, sg(sr)), 0) + LSGAN(D(lr, hr), 1))
  * loss_G = LSGAN(D_sg(lr, sr), 1) + FeatMatch(D_sg(lr, sr), sg(D(lr, hr)))

where sg detaches and D_sg is D called with detached *parameters*, so the
gradient of loss_G reaches G through D's activations and never D.  One
``torch.autograd.grad`` of loss_G + loss_D gives both gradient sets, as the
JAX step's one ``jax.grad`` does, and the two optimizers step.

Under data parallelism (``ranks``; ``parallel/mesh.py``) each rank steps on
its rows of the global batch with the same state: the attention stack's
BatchNorm takes the global statistics (``create_train_state`` marks it),
each loss is this rank's share of the global loss (``models/losses.py``),
the gradients are summed over the ranks before either optimizer reads them,
and the reported metrics are the sums of the shares: the global losses.
"""

from __future__ import annotations

import collections
import contextlib
import gc
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.models.losses import feature_matching_loss, gan_loss
from mdctgan_tpu_torch.ops import mdct_kernels
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.parallel import mesh
from mdctgan_tpu_torch.train.schedule import OptimizerSpec
from mdctgan_tpu_torch.train.state import GANTrainState
from mdctgan_tpu_torch.utils import tracing


def generator_forward(
    generator: nn.Module,
    transform: SpectralTransform,
    lr_spectro: torch.Tensor,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Normalized LR spectrum (B, 1, F, K) -> SR spectrum: the abs input
    channel, the generator (in its current train/eval mode) and, under
    fit_residual, the LR spectrum added.  ``sample_mask`` restricts the
    attention stack's BatchNorm batch statistics to the real rows."""
    sr = generator(transform.g_input(lr_spectro), sample_mask)
    if transform.cfg.fit_residual:
        sr = sr + lr_spectro
    return sr


def _params(opt: torch.optim.Optimizer):
    return [p for group in opt.param_groups for p in group["params"]]


_LIVE_KEYS = 2  # input shapes kept captured: the full batch and an epoch's padded tail


def given_inputs(batch: Dict[str, torch.Tensor], pool_old: Optional[torch.Tensor] = None,
                 pool_mask: Optional[torch.Tensor] = None,
                 sample_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A train step call's tensor inputs by name, those given."""
    given = dict(lr_audio=batch["lr_audio"], hr_audio=batch["hr_audio"], pool_old=pool_old,
                 pool_mask=pool_mask, sample_mask=sample_mask)
    return {k: t for k, t in given.items() if t is not None}


def graph_key(ranks: Optional[mesh.Ranks], draws: bool, given: Dict[str, torch.Tensor],
              g_params: List[torch.Tensor], d_params: List[torch.Tensor]) -> Optional[tuple]:
    """The key under which ``build_train_step`` captures a call with the
    inputs ``given`` (``given_inputs``), or None where the call runs
    eagerly: off the card, under ``ranks`` (the data-parallel step's
    all-reduces stay eager), or where the step draws from the CPU ``noise``
    generator (``draws``).  The key holds the inputs' device, names,
    shapes and dtypes (so whether ``sample_mask`` and the pool's inputs are
    given), and the parameters each optimizer steps, by identity (the
    ``niter_fix_global`` unfreeze gives G's optimizer more)."""
    device = given["lr_audio"].device
    if device.type != "cuda" or ranks is not None or draws:
        return None
    return (device, tuple((k, tuple(t.shape), t.dtype) for k, t in given.items()),
            tuple(map(id, g_params)), tuple(map(id, d_params)))


class _Captured(NamedTuple):
    """One key's graphs in capture order, the static tensors they read
    (``inputs``) and write (``metrics``, ``grads``, ``fake_concat``), the
    parameters the gradients are for, and the K1/K2 launches a replay makes."""
    graphs: List[Tuple[str, "torch.cuda.CUDAGraph"]]
    inputs: Dict[str, torch.Tensor]
    metrics: Dict[str, torch.Tensor]
    grads: List[torch.Tensor]
    fake_concat: Optional[torch.Tensor]
    params: Tuple[List[torch.Tensor], List[torch.Tensor]]
    launches: Dict[str, int]


def build_train_step(
    transform: SpectralTransform,
    g_tx: OptimizerSpec,
    d_tx: OptimizerSpec,
    use_lsgan: bool = True,
    lambda_feat: float = 10.0,
    n_layers_d: int = 3,
    num_d: int = 3,
    use_ganfeat: bool = True,
    use_pool: bool = False,
    allow_tf32: bool = False,
    noise: Optional[torch.Generator] = None,
    ranks: Optional[mesh.Ranks] = None,
) -> Callable[..., Tuple[GANTrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch, pool_old=None, pool_mask=None,
    sample_mask=None, mark=None) -> (state, metrics)``.

    ``batch`` holds ``lr_audio`` and ``hr_audio``, (B, T) float32 on the
    state's device; each gives one K1 launch on a CUDA tensor where the
    transform is ``fused``, else one product of the matmul form, outside
    the autograd graph (the spectra are constants of the step).  ``noise``
    (a CPU ``torch.Generator``) feeds the masks' noise fills; only a masked
    configuration without ``fit_residual`` draws from it.  The step
    updates ``state`` in place: G runs once in train mode (its BatchNorm
    running statistics move once), both optimizers step with their
    schedules read at the update count, then ``state.step`` grows by one.
    ``g_tx``/``d_tx`` give the schedules and must be the specs the state's
    optimizers were built from.  With their ``accum_steps`` k > 1 each
    parameter's ``.grad`` keeps the running mean of the micro-batches'
    gradients (``optax.MultiSteps``' form) and each optimizer steps on the
    k-th call of its window, at its update count (``GANTrainState.
    update_count``): D's window starts at step 0, G's at
    ``state.g_window_start``, which the ``niter_fix_global`` unfreeze
    moves.

    With ``use_pool`` the D_fake input is the per-sample mix
    ``m*pool_old + (1-m)*fake`` of ``ImagePool.presample``'s ``(pool_old,
    pool_mask)`` (as tensors on the device), and ``metrics["fake_concat"]``
    carries the current fakes for ``ImagePool.commit``.  ``sample_mask``
    (B,) 0/1 weights every loss term per sample and masks the BatchNorm
    statistics: a padded tail batch steps as the smaller batch would.
    ``mark(name)``, when given, is called after each part of the step
    ("k1", "g_forward", "d_forward", "backward", "optimizer") for timing;
    the call is the last of the part's span (``utils/tracing.py``), named
    ``step.<part>`` under the step's root span ``step``.
    The step runs under ``float32_policy(allow_tf32)``: TF32 off unless a
    caller asks for it to read what it costs.

    On the card the parts k1 to backward replay as CUDA graphs, one a part,
    so the host launches four graphs where it would launch thousands of
    kernels.  Each call has a key (``graph_key``); a key's first call runs
    eagerly, which sets up what a capture cannot (Adam's state, the
    libraries' first use); its second call captures the four parts into
    one memory pool and steps by replaying them, as does every later call.  The batch and the mask and
    pool inputs are copied into the graphs' static inputs, ``mark`` is
    called after each part's replay (its events then time the part on the
    card), the returned metrics are copies, and the optimizer part runs
    eagerly on the gradients, which the backward graph writes into buffers
    outside its pool (copied first where ``accum_steps`` > 1 keeps them past
    the next replay).  The last ``_LIVE_KEYS`` keys keep their graphs, all
    of one set of parameters: a call with others (another state, the
    unfreeze) drops them.  They go with the ``train_step`` that holds them.
    Counters (``utils/tracing.py``): ``step.calls``, ``step.graph_captures``,
    ``step.graph_replays``; a replay adds its captured launches to
    ``mdct_kernels.LAUNCHES``.

    With ``ranks`` the step is one rank's part of a data-parallel step (the
    module docstring): ``batch``, ``sample_mask`` and the pool's inputs
    hold this rank's rows, the noise fills are drawn at the global shape,
    and ``fake_concat`` holds this rank's fakes.  Every rank must call it
    with the same state and the same number of rows."""

    if g_tx.accum_steps != d_tx.accum_steps:
        raise ValueError("G and D must accumulate over the same number of micro-batches")
    accum = g_tx.accum_steps
    draws = noise is not None and transform.draws()
    # the keys seen (None: once, eager) or captured, all of one set of parameters
    captured: "collections.OrderedDict[tuple, Optional[_Captured]]" = collections.OrderedDict()
    streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def d_concat(lr_spec, img_spec):
        return torch.cat((lr_spec, transform.g_input(img_spec)), dim=1)

    def train_step(state: GANTrainState, batch: Dict[str, torch.Tensor],
                   pool_old: Optional[torch.Tensor] = None,
                   pool_mask: Optional[torch.Tensor] = None,
                   sample_mask: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None):
        tracing.count("step.calls")
        mark = mark or (lambda name: None)
        with tracing.span("step"), float32_policy(allow_tf32):
            params = _params(state.g_opt), _params(state.d_opt)
            given = given_inputs(batch, pool_old, pool_mask, sample_mask)
            key = graph_key(ranks, draws, given, *params)
            if key is None:
                return eager(state, params, given, mark)
            if captured and next(iter(captured))[-2:] != key[-2:]:
                captured.clear()  # another state or the unfreeze: its graphs are stale
            if key not in captured:
                captured[key] = None
                while len(captured) > _LIVE_KEYS:
                    captured.popitem(last=False)
                return eager(state, params, given, mark)
            if captured[key] is None:
                device = key[0]
                if device not in streams:
                    streams[device] = torch.cuda.Stream(device)
                captured[key] = capture(streams[device], state, params, given)
            captured.move_to_end(key)
            return replay(captured[key], state, given, mark)

    def eager(state, params, given, mark):
        @contextlib.contextmanager
        def part(name):
            with tracing.span("step." + name):
                yield
                mark(name)

        metrics, grads, fake_concat = forward_backward(state, params, given, part)
        optimize(state, params, grads, mark, alias=True)
        if use_pool:
            metrics["fake_concat"] = fake_concat
        return state, metrics

    def capture(stream, state, params, given):
        """The key's graphs: the parts k1 to backward captured on ``stream``
        into one pool, reading copies of the call's inputs and writing the
        gradients to buffers outside the pool (a state that keeps them as
        ``.grad`` then holds no pool).  Nothing runs."""
        gc.collect()  # dropped train steps' graphs free their pools first
        inputs = {k: t.clone() for k, t in given.items()}
        grads_out = [torch.empty_like(p) for p in params[0] + params[1]]
        pool = torch.cuda.graph_pool_handle()
        graphs = []

        @contextlib.contextmanager
        def part(name):
            graph = torch.cuda.CUDAGraph()
            # thread_local: the input pipeline's thread pins memory meanwhile
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                yield
            graphs.append((name, graph))

        before = dict(mdct_kernels.LAUNCHES)
        metrics, grads, fake_concat = forward_backward(state, params, inputs, part, grads_out)
        # cuBLAS keeps a workspace per handle and stream, made in the pool
        # while capturing; the graphs keep its memory, the handles let it go,
        # so nothing outside holds the pool once the graphs are dropped
        torch._C._cuda_clearCublasWorkspaces()
        launches = {k: n - before[k] for k, n in mdct_kernels.LAUNCHES.items()}
        for k, n in launches.items():  # captured, not run: each replay counts them
            mdct_kernels.LAUNCHES[k] -= n
        tracing.count("step.graph_captures")
        return _Captured(graphs, inputs, metrics, grads, fake_concat, params, launches)

    def replay(entry: _Captured, state, given, mark):
        state.generator.train()
        for name, graph in entry.graphs:
            with tracing.span("step." + name):
                if name == "k1":
                    for k, static in entry.inputs.items():
                        static.copy_(given[k])
                graph.replay()
                mark(name)
        for k, n in entry.launches.items():
            mdct_kernels.LAUNCHES[k] += n
        tracing.count("step.graph_replays")
        metrics = {k: v.clone() for k, v in entry.metrics.items()}
        optimize(state, entry.params, entry.grads, mark, alias=accum == 1)
        if use_pool:
            metrics["fake_concat"] = entry.fake_concat.clone()
        return state, metrics

    def forward_backward(state, params, given, part, grads_out=None):
        """The parts k1 to backward on the inputs ``given``, each under
        ``part(name)`` -> (metrics, gradients of ``params``' G then D
        leaves, written into ``grads_out`` where given, fake_concat)."""
        lr_audio, hr_audio = given["lr_audio"], given["hr_audio"]
        pool_old, pool_mask = given.get("pool_old"), given.get("pool_mask")
        sample_mask = given.get("sample_mask")
        with part("k1"):
            gen, disc = state.generator, state.discriminator
            bsz = lr_audio.shape[0]
            rows = total = None
            if ranks is not None:
                rows = ranks.global_rows(bsz)
                # the global batch's weight, the losses' common denominator
                total = (sample_mask.sum().reshape(1) if sample_mask is not None
                         else torch.full((1,), float(bsz), device=lr_audio.device))
                mesh.all_reduce_([total], ranks)
                total = torch.clamp(total[0], min=1.0)
            with torch.no_grad():
                lr_spec, _, _ = transform.lr_forward(lr_audio, noise, rows)
                hr_spec, _, _ = transform.hr_forward(hr_audio, noise, rows)

        with part("g_forward"):
            gen.train()
            sr_spec = generator_forward(gen, transform, lr_spec, sample_mask)

        with part("d_forward"):
            frozen_d = {k: v.detach() for k, v in disc.named_parameters()}
            pred_fake_g = torch.func.functional_call(disc, frozen_d,
                                                     (d_concat(lr_spec, sr_spec),))
            fake_concat = d_concat(lr_spec, sr_spec.detach())
            if use_pool:
                m = pool_mask.to(fake_concat.dtype).reshape(-1, 1, 1, 1)
                d_fake_in = m * pool_old + (1.0 - m) * fake_concat
            else:
                d_fake_in = fake_concat
            # D_fake and D_real share the live parameters: one 2B call, split
            # back per scale and layer, fake rows first
            both = disc(torch.cat((d_fake_in, d_concat(lr_spec, hr_spec)), dim=0))
            pred_fake_d = [[f[:bsz] for f in scale] for scale in both]
            pred_real = [[f[bsz:] for f in scale] for scale in both]

            weights = dict(sample_weight=sample_mask, total_weight=total)
            loss_g_gan = gan_loss(pred_fake_g, True, use_lsgan, **weights)
            loss_g_feat = (
                feature_matching_loss(pred_fake_g, pred_real, n_layers_d, num_d,
                                      lambda_feat, **weights)
                if use_ganfeat else torch.zeros((), device=lr_spec.device))
            loss_d_fake = gan_loss(pred_fake_d, False, use_lsgan, **weights)
            loss_d_real = gan_loss(pred_real, True, use_lsgan, **weights)
            loss_g = loss_g_gan + loss_g_feat
            loss_d = 0.5 * (loss_d_fake + loss_d_real)

        with part("backward"):
            metrics = {
                "G_GAN": loss_g_gan, "G_GAN_Feat": loss_g_feat,
                "D_real": loss_d_real, "D_fake": loss_d_fake,
                "loss_G": loss_g, "loss_D": loss_d,
            }
            metrics = {k: v.detach() for k, v in metrics.items()}
            grads = torch.autograd.grad(loss_g + loss_d, params[0] + params[1])
            if grads_out is not None:
                torch._foreach_copy_(grads_out, grads)
                grads = grads_out
            if ranks is not None:
                # the ranks' shares of the metrics ride in the gradients' buckets
                shares = torch.stack([v.to(loss_d.dtype) for v in metrics.values()])
                mesh.all_reduce_([*grads, shares], ranks)
                metrics = dict(zip(metrics, shares.unbind()))
        return metrics, grads, fake_concat

    def optimize(state, params, grads, mark, alias):
        """The optimizer part, eager on every path.  A window's first
        micro-batch's gradients become ``.grad``: themselves with ``alias``,
        else copies (a graph's buffers, which the next replay overwrites)."""
        with tracing.span("step.optimizer"):
            g_params, d_params = params
            for net, net_params, net_grads, tx, optimizer in (
                    ("G", g_params, grads[:len(g_params)], g_tx, state.g_opt),
                    ("D", d_params, grads[len(g_params):], d_tx, state.d_opt)):
                n = state.micro_index(net, accum)  # micro-batches already in this update
                for p, g in zip(net_params, net_grads):
                    if n == 0 or p.grad is None:
                        p.grad = g if alias else g.clone()
                    else:
                        p.grad = (g + n * p.grad) / (n + 1)
                if n == accum - 1:
                    tx.set_lr(optimizer, state.update_count(net, accum))
                    optimizer.step()
            state.step += 1
            mark("optimizer")

    return train_step


class InferenceModule(nn.Module):
    """The serving chain as one module, ``forward(lr_audio, phase=None,
    rows=None)``: LR waveform segments (B, T) -> (SR spectro (B, C, F, K),
    SR waveform (B, out_length)).

    The LR spectrum (``lr_forward``: one K1 launch where the transform is
    ``fused``, masked under ``mask``) gets its abs channel and goes through
    the generator; under fit_residual the LR band of the output is scaled
    by 1e-3 and the LR spectrum added; the result is denormalized with the
    *LR* normalization bounds and synthesized (one K2 launch where
    ``fused``) with the LR sign.  ``phase``, a CPU ``torch.Generator``,
    draws the dB mode's pseudo-phase above the LR rows (ones without
    one); ``rows`` draws it at a global batch's shape (``ops/features.py``),
    for one replica's share of a batch.

    The transform's matrices are the module's buffers (``spectro_mat``,
    ``synth_mat``), so ``torch.export`` (``export_cli.py``) keeps them as the
    program's own state beside the generator's weights: where the buffers
    are no longer the transform's own tensors (export puts its own in their
    place), a call reads them through ``SpectralTransform.with_matrices``;
    otherwise it runs the transform as given (which may be a stand-in, such
    as ``train/grad_truth.py``'s ``SharedSpectra``).  ``build_inference_fn``
    runs the same module."""

    def __init__(self, generator: nn.Module, transform: SpectralTransform,
                 out_length: Optional[int] = None):
        super().__init__()
        self.generator, self.transform, self.out_length = generator, transform, out_length
        self.register_buffer("spectro_mat", transform.spectro_mat)
        self.register_buffer("synth_mat", transform.synth_mat)

    def forward(self, lr_audio: torch.Tensor, phase: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None):
        transform = self.transform
        if self.spectro_mat is not transform.spectro_mat:  # export's own state
            transform = transform.with_matrices(self.spectro_mat, self.synth_mat)
        cfg = transform.cfg
        lr_spec, lr_pha, lr_np = transform.lr_forward(lr_audio)
        sr = self.generator(transform.g_input(lr_spec))
        if cfg.fit_residual:
            lr_part = int(sr.shape[-1] / cfg.up_ratio)
            sr[..., :lr_part] *= 1e-3
            sr = sr + lr_spec
        sr_audio = transform.to_audio(sr, lr_np, lr_pha, generator=phase,
                                      out_length=self.out_length, rows=rows)
        return sr, sr_audio


def build_inference_fn(
    generator: nn.Module,
    transform: SpectralTransform,
    out_length: Optional[int] = None,
) -> Callable:
    """``infer(lr_audio, phase=None, rows=None)``: ``InferenceModule``'s
    forward under ``torch.inference_mode()`` and the float32 policy."""
    module = InferenceModule(generator, transform, out_length)

    @torch.inference_mode()
    @float32_policy()
    def infer(lr_audio: torch.Tensor, phase: Optional[torch.Generator] = None,
              rows: Optional[Tuple[int, int]] = None):
        return module(lr_audio, phase, rows)

    return infer
