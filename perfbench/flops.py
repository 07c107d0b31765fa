"""Model FLOPs, counted once at set-up by ``torch.utils.flop_counter.
FlopCounterMode`` over the plain reference on the meta device (no memory,
no arithmetic), at the cell's shapes.  The count is the work's, not the
port's: a change that removes work from the port leaves it as it is.
Only the networks count: the transform, the norms and the activations are
outside the counter's operations."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import models, train


def _spectra(opt, batch: int):
    return torch.zeros(batch, 1, opt["bins"], opt["n_fft"] // 2)


def train_step_flops(opt, batch: int) -> float:
    """G forward and backward and the step's D calls forward and backward:
    one ``train.losses`` and its ``autograd.grad`` at ``batch`` rows."""
    with torch.device("meta"):
        g, d = models.build_generator(opt), models.Discriminator(opt)
        lr, hr = _spectra(opt, batch), _spectra(opt, batch)
        params = list(g.parameters()) + list(d.parameters())
        with FlopCounterMode(display=False) as counter:
            ls = train.losses(g, d, lr, hr, opt)
            torch.autograd.grad(ls["loss_G"] + ls["loss_D"], params)
    return float(counter.get_total_flops())


def generator_flops(opt) -> float:
    """G forward of one segment (eval mode)."""
    with torch.device("meta"):
        g = models.build_generator(opt).eval()
        spec = _spectra(opt, 1)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            g(models.g_input(spec, float(opt["norm_range"][0])))
    return float(counter.get_total_flops())
