"""Train state: the port of ``mdctgan_tpu/train/state.py``.

Where the JAX state holds parameter trees and optax states, this one holds
the two modules (whose parameters and BatchNorm buffers are the state),
their two optimizers and the step count, which is also the position of the
learning-rate schedule.  ``g_window_start`` is the step at which G's
current accumulation window began: 0, or the ``niter_fix_global`` unfreeze,
where the JAX package gives G a fresh ``optax.MultiSteps`` state while D's
runs on.

Under data parallelism every rank holds the whole state, the same bits on
every rank: ``replicate_state`` broadcasts rank 0's after the state is
built and after a restore, and the step keeps it so.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from mdctgan_tpu_torch.device import resolve_device
from mdctgan_tpu_torch.models.attention import sync_batch_stats
from mdctgan_tpu_torch.parallel import mesh
from mdctgan_tpu_torch.train.schedule import OptimizerSpec
from mdctgan_tpu_torch.weights import init_weights


@dataclasses.dataclass
class GANTrainState:
    step: int
    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_window_start: int = 0

    def params_count(self) -> int:
        return sum(p.numel() for p in self.generator.parameters())

    def micro_index(self, net: str, accum: int) -> int:
        """How many micro-batches of ``net``'s (``"G"`` or ``"D"``) current
        update are already accumulated."""
        start = self.g_window_start if net == "G" else 0
        return (self.step - start) % accum

    def update_count(self, net: str, accum: int) -> int:
        """``net``'s completed updates, the position of its schedule: D's
        is ``step // accum``; G's carries the count it had at the unfreeze
        and counts on from its own window start."""
        if net == "D":
            return self.step // accum
        return self.g_window_start // accum + (self.step - self.g_window_start) // accum


def create_train_state(
    generator: nn.Module,
    discriminator: nn.Module,
    g_tx: OptimizerSpec,
    d_tx: OptimizerSpec,
    device="cuda",
    rng: Optional[torch.Generator] = None,
    ranks: Optional[mesh.Ranks] = None,
) -> GANTrainState:
    """Both modules on ``device`` in train mode, with their optimizers and
    step 0.  With ``rng`` the weights get the reference initialisation drawn
    from it (``weights.init_weights``, G then D); without, they stay as
    given (a ``load_state_dict`` before this call).  Raises when ``device``
    is CUDA and CUDA is absent.  With ``ranks`` G's BatchNorm takes the
    global batch's statistics (``attention.sync_batch_stats``) and the
    state is rank 0's on every rank (``replicate_state``)."""
    dev = resolve_device(device)
    if rng is not None:
        init_weights(generator, rng)
        init_weights(discriminator, rng)
    generator.to(dev).train()
    discriminator.to(dev).train()
    state = GANTrainState(
        step=0,
        generator=generator,
        discriminator=discriminator,
        g_opt=g_tx.init(generator.named_parameters()),
        d_opt=d_tx.init(discriminator.named_parameters()),
    )
    if ranks is not None:
        sync_batch_stats(generator)
        replicate_state(state, ranks)
    return state


def replicate_state(state: GANTrainState, ranks: mesh.Ranks) -> GANTrainState:
    """Rank 0's state on every rank, in place: both modules' parameters and
    buffers, both optimizers' state and the gradients of an update being
    accumulated.  Every rank must hold the same structure: the same
    modules, optimizers and accumulated parameters, as a state built from
    the same options and restored from the same save does."""
    tensors = [t for module in (state.generator, state.discriminator)
               for t in module.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        tensors += [v for per in opt.state.values() for v in per.values()
                    if isinstance(v, torch.Tensor)]
    tensors += [p.grad for module in (state.generator, state.discriminator)
                for p in module.parameters() if p.grad is not None]
    mesh.replicate(tensors, ranks)
    return state
