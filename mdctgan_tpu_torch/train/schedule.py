"""The learning-rate schedule and the two optimizers: the port of
``mdctgan_tpu/train/schedule.py``.

An optimizer is given as an ``OptimizerSpec`` (the counterpart of an optax
``GradientTransformation``): how to build a ``torch.optim`` optimizer over
parameters, the schedule of its learning rate over the update count, and
how many micro-batches each update averages (``optax.MultiSteps``).  The
train state's ``step`` counts micro-batches, as the JAX state's does; the
update count is ``step // accum_steps``, kept outside the optimizer: the
step sets every group's ``lr`` to ``schedule(step // accum_steps)`` before
``optimizer.step()``, so the first update uses ``schedule(0)``, as
``optax.adam(schedule)`` does.
"""

from __future__ import annotations

import dataclasses
import functools
from math import lcm
from typing import Callable, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """``factory(params)`` builds the optimizer; ``schedule(count)``, when
    given, sets its learning rate before each update; ``labels`` maps
    parameter names to ``"train"`` or ``"frozen"`` (``freeze.masked_optimizer``)
    and frozen parameters are left out of the optimizer; each update
    averages the gradients of ``accum_steps`` micro-batches."""

    factory: Callable[[list], torch.optim.Optimizer]
    schedule: Optional[Schedule] = None
    labels: Optional[Mapping[str, str]] = None
    accum_steps: int = 1

    def init(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]]
             ) -> torch.optim.Optimizer:
        named = list(named_params)
        if self.labels is not None:
            missing = sorted({n for n, _ in named} - set(self.labels))
            if missing:
                raise KeyError(f"no freeze label for {missing[:5]}")
            named = [(n, p) for n, p in named if self.labels[n] == "train"]
        return self.factory([p for _, p in named])

    def set_lr(self, optimizer: torch.optim.Optimizer, count: int) -> None:
        if self.schedule is not None:
            lr = self.schedule(count)
            for group in optimizer.param_groups:
                group["lr"] = lr


def pix2pixhd_lr_schedule(lr0: float, niter: int, niter_decay: int,
                          steps_per_epoch: int) -> Schedule:
    """``lr0`` for ``niter`` epochs, then linearly to 0 over ``niter_decay``
    epochs, by the 0-indexed epoch ``count // steps_per_epoch``.  Computed
    in float32, as the JAX schedule is, so both give the same values."""
    f32 = np.float32

    def schedule(count: int) -> float:
        epoch0 = int(count) // max(steps_per_epoch, 1)
        past = max(epoch0 - niter, 0)
        frac = f32(1.0) - f32(past) / f32(max(niter_decay, 1))
        return float(f32(lr0) * np.clip(frac, f32(0.0), f32(1.0)))

    return schedule


def make_optimizers(lr: float, beta1: float, niter: int, niter_decay: int,
                    steps_per_epoch: int, accum_steps: int = 1
                    ) -> Tuple[OptimizerSpec, OptimizerSpec]:
    """The reference's two optimizers: Adam(lr, betas (beta1, 0.999),
    eps 1e-8) for G and for D, with the epoch-linear decay.  With
    ``accum_steps`` k > 1 each update averages k micro-batches and the
    schedule counts updates, ``steps_per_epoch // k`` an epoch, so epoch
    boundaries stay where they were (``optax.MultiSteps`` in JAX)."""
    accum = max(int(accum_steps), 1)
    sched = pix2pixhd_lr_schedule(lr, niter, niter_decay, max(steps_per_epoch // accum, 1))
    adam = functools.partial(torch.optim.Adam, lr=lr, betas=(beta1, 0.999), eps=1e-8)
    return OptimizerSpec(adam, sched, accum_steps=accum), OptimizerSpec(adam, sched, accum_steps=accum)


def carry_schedule_count(state, g_tx: OptimizerSpec):
    """The ``niter_fix_global`` unfreeze: ``state`` gets a fresh G optimizer
    from ``g_tx`` (new Adam moments and bias correction, like the
    reference's new Adam) and, as the JAX package's fresh ``optax.MultiSteps``
    state, a fresh accumulation window: G's partial gradients are dropped
    and its window starts at ``state.step``.  Its schedule goes on from the
    updates G had made (``GANTrainState.update_count``), which no optimizer
    holds, so the decay keeps counting epochs from the start of training.
    D's window runs on.  Returns ``state``."""
    state.g_opt = g_tx.init(state.generator.named_parameters())
    for p in state.generator.parameters():
        p.grad = None
    state.g_window_start = state.step
    return state


class FreqClock:
    """Sample-counted trigger cadence for print/display/save/eval.

    The reference counts ``total_steps`` in samples, snaps ``print_freq`` to
    ``lcm(print_freq, batchSize)`` and phases every trigger by the resume
    offset, so a resumed run keeps the original cadence.  ``tick()``
    advances one batch and returns which triggers fire.
    """

    def __init__(self, batch_size: int, start_samples: int, print_freq: int,
                 display_freq: int, save_latest_freq: int, eval_freq: int,
                 eval_enabled: bool):
        self.batch = batch_size
        self.print_freq = lcm(max(print_freq, 1), batch_size)
        self.display_freq = max(display_freq, 1)
        self.save_freq = max(save_latest_freq, 1)
        self.eval_freq = max(eval_freq, 1)
        self.total = start_samples
        self.print_delta = start_samples % self.print_freq
        self.display_delta = start_samples % self.display_freq
        self.save_delta = start_samples % self.save_freq
        # -1: eval never fires (the reference evaluates only with a
        # validation split)
        self.eval_delta = (start_samples % self.eval_freq
                           if (eval_enabled and eval_freq > 0) else -1)

    def tick(self):
        self.total += self.batch
        return {
            "print": self.total % self.print_freq == self.print_delta,
            "display": self.total % self.display_freq == self.display_delta,
            "save": self.total % self.save_freq == self.save_delta,
            "eval": self.eval_delta >= 0
                    and self.total % self.eval_freq == self.eval_delta,
        }
