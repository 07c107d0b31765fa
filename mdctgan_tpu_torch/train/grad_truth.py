"""One flagship-style train step's gradients, for holding a run against
another: on the card against the CPU, float32 against a float64 truth.

One SGD(lr=1) step (its update is the gradient) of G and D from given
weights, through ``build_train_step``; per tensor the normwise error of one
run's gradients against another's, as a share of the JAX package's flagship
bounds (G 2.5e-2, D 5e-3, floor 1e-3, ``tests/test_flagship_parity.py``),
optionally widened per tensor by a float64 conditioning term.
``chip_smoke.py`` and ``probes/flagship_grad_truth.py`` use it.

``inputs("noise")`` is the input form of the JAX package's flagship gradient
certificate: HR white noise of sigma 0.1 and LR = HR plus noise of sigma
0.01.  ``inputs("speech")`` is ``data.synthetic.speech_like`` at 48 kHz with
its LR made by ``degrade_lr``, so its upper two thirds of the spectrum are
near zero.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

BOUNDS = {"G": 2.5e-2, "D": 5e-3}
FLOOR = 1e-3
# How many times the float64 step's own movement under float32 rounding of
# its input spectra a card step may differ from the CPU's beyond BOUNDS.
# Measured over four seeded flagship draws at batch 2 on an H100
# (probes/flagship_grad_truth.py): float32 on the card needs at most 0.07,
# the card with TF32 allowed at least 25.9.
CONDITIONING_FACTOR = 2.0
Grads = Dict[str, Dict[str, torch.Tensor]]


def inputs(kind: str, rng: np.random.Generator, batch: int, seg: int
           ) -> Dict[str, np.ndarray]:
    """``{"lr_audio", "hr_audio"}``, (batch, seg) float32."""
    if kind == "noise":
        hr = (0.1 * rng.standard_normal((batch, seg))).astype(np.float32)
        lr = (hr + 0.01 * rng.standard_normal((batch, seg))).astype(np.float32)
        return {"lr_audio": lr, "hr_audio": hr}
    if kind != "speech":
        raise ValueError(f"unknown data {kind!r}")
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.ops.resample import degrade_lr

    hr = speech_like(rng, batch * seg / 48000, 48000)[: batch * seg].reshape(batch, seg)
    with torch.no_grad():
        lr = degrade_lr(torch.from_numpy(hr), 48000, 16000, 48000)[:, :seg]
    return {"lr_audio": lr.contiguous().numpy(), "hr_audio": hr}


def load_nets(opt: Mapping, g_state: Mapping, d_state: Mapping,
              dtype=torch.float32) -> Dict[str, torch.nn.Module]:
    """``{"G": generator, "D": discriminator}`` of ``opt`` holding the given
    state dicts (strictly), in ``dtype``, on the CPU."""
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator

    nets = {"G": build_generator(opt), "D": build_discriminator(opt)}
    for net, sd in (("G", g_state), ("D", d_state)):
        nets[net].load_state_dict(sd, strict=True)
        nets[net].to(dtype)
    return nets


def sgd_step(opt: Mapping, nets: Mapping[str, torch.nn.Module], transform,
             batch: Mapping[str, np.ndarray], device, allow_tf32: bool = False,
             sample_mask: Optional[torch.Tensor] = None, ranks=None, tx=None
             ) -> Tuple[Dict[str, float], Grads]:
    """One SGD(lr=1) step of ``build_train_step`` on ``nets`` (moved to
    ``device``; the inputs take the dtype of G's first parameter): its
    losses, and its gradients (the updates) as float64 CPU tensors by
    network and name.  With ``ranks`` (``parallel.mesh.Ranks``), one rank's
    part of a data-parallel step on its rows ``batch``.  ``tx`` (an
    ``OptimizerSpec`` for both nets) replaces SGD(1); the updates are then
    its own, not the gradients."""
    from mdctgan_tpu_torch.options import train_options
    from mdctgan_tpu_torch.train.schedule import OptimizerSpec
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step

    tro = train_options(opt)
    dtype = next(nets["G"].parameters()).dtype
    if tx is None:
        tx = OptimizerSpec(functools.partial(torch.optim.SGD, lr=1.0))
    state = create_train_state(nets["G"], nets["D"], tx, tx, device=device, ranks=ranks)
    step = build_train_step(
        transform, tx, tx, use_lsgan=not tro["no_lsgan"], lambda_feat=tro["lambda_feat"],
        n_layers_d=tro["n_layers_D"], num_d=tro["num_D"],
        use_ganfeat=not tro["no_ganFeat_loss"], allow_tf32=allow_tf32, ranks=ranks)
    before = {n: {k: p.detach().clone() for k, p in m.named_parameters()}
              for n, m in nets.items()}
    state, metrics = step(state, {k: torch.from_numpy(v).to(device, dtype)
                                  for k, v in batch.items()}, sample_mask=sample_mask)
    if state.step != 1:
        raise AssertionError(f"the step count is {state.step} after one step")
    grads = {n: {k: (before[n][k] - p.detach()).cpu().double()
                 for k, p in m.named_parameters()} for n, m in nets.items()}
    return {k: float(v) for k, v in metrics.items()}, grads


def sgd_grads(opt: Mapping, g_state: Mapping, d_state: Mapping,
              batch: Mapping[str, np.ndarray], device, dtype=torch.float32,
              allow_tf32: bool = False, sample_mask: Optional[torch.Tensor] = None
              ) -> Tuple[Dict[str, float], Grads]:
    """``sgd_step`` of G and D loaded from the given state dicts in
    ``dtype``, with the spectral transform of ``opt`` on ``device``."""
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import spectral_config_from_opt

    transform = SpectralTransform(spectral_config_from_opt(opt), device, dtype)
    return sgd_step(opt, load_nets(opt, g_state, d_state, dtype), transform, batch, device,
                    allow_tf32, sample_mask)


class SharedSpectra:
    """A spectral transform whose train-step spectra are those of another
    transform (on another device or in another dtype), moved to this one's
    device and dtype, so that two runs of the step see the same input."""

    def __init__(self, transform, source):
        self.transform, self.source = transform, source

    def __getattr__(self, attr):
        return getattr(self.transform, attr)

    def _from_source(self, forward, audio, generator, rows):
        src, dst = self.source, self.transform
        spec, pha, params = forward(audio.to(src.device, src.dtype), generator, rows)

        def move(t):
            return t.to(dst.device, dst.dtype) if isinstance(t, torch.Tensor) else t

        return move(spec), move(pha), {k: move(v) for k, v in params.items()}

    def lr_forward(self, lr_audio, generator=None, rows=None):
        return self._from_source(self.source.lr_forward, lr_audio, generator, rows)

    def hr_forward(self, hr_audio, generator=None, rows=None):
        return self._from_source(self.source.hr_forward, hr_audio, generator, rows)


def normwise(ref: Mapping[str, torch.Tensor], got: Mapping[str, torch.Tensor],
             rel: float, floor: float = FLOOR, top: int = 3,
             slack: Optional[Mapping[str, float]] = None) -> Dict:
    """Per tensor ||got - ref|| as a share of rel*||ref|| + floor (+
    ``slack[name]``), and as a share of ||ref||; the largest of each and
    the ``top`` worst tensors."""
    shares, rels = {}, {}
    for k, r in ref.items():
        err, norm = float((got[k] - r).norm()), float(r.norm())
        extra = slack[k] if slack is not None else 0.0
        shares[k], rels[k] = err / (rel * norm + floor + extra), err / max(norm, 1e-30)
    worst = sorted(shares, key=shares.get, reverse=True)[:top]
    return {"max_share": max(shares.values()), "max_rel_err": max(rels.values()),
            "worst": [{"name": k, "share": shares[k], "rel_err": rels[k],
                       "ref_norm": float(ref[k].norm())} for k in worst],
            "shares": shares}
