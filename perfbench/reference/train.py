"""One GAN train step and Adam, in float32: the losses, the gradients of
both networks from one ``torch.autograd.grad``, and the updates.

    loss_D = 0.5 (LSGAN(D(lr, sg(sr)), 0) + LSGAN(D(lr, hr), 1))
    loss_G = LSGAN(D_sg(lr, sr), 1) + FeatMatch(D_sg(lr, sr), sg(D(lr, hr)))

with sr = G(lr, |lr|) + lr (fit_residual), sg a detach and D_sg D with
detached parameters; each LSGAN term a mean over the batch and summed
over the scales; feature matching the L1 of every intermediate feature
weighted lambda / num_D * 4 / (n_layers + 1).  Adam (beta2 0.999, eps
1e-8) with bias correction.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.models import g_input


def losses(G, D, lr_spec: torch.Tensor, hr_spec: torch.Tensor, opt) -> Dict[str, torch.Tensor]:
    """The step's six losses on normalised spectra (B, 1, frames, N/2)."""
    low = float(opt["norm_range"][0])
    b = lr_spec.shape[0]

    def pair(img):
        return torch.cat((lr_spec, g_input(img, low)), dim=1)

    sr = G(g_input(lr_spec, low)) + lr_spec
    frozen = {k: v.detach() for k, v in D.named_parameters()}
    pred_fake_g = torch.func.functional_call(D, frozen, (pair(sr),))
    both = D(torch.cat((pair(sr.detach()), pair(hr_spec)), dim=0))
    pred_fake_d = [[f[:b] for f in scale] for scale in both]
    pred_real = [[f[b:] for f in scale] for scale in both]

    def lsgan(preds, target):
        return sum(((scale[-1] - target) ** 2).mean() for scale in preds)

    weight = 1.0 / opt["num_D"] * 4.0 / (opt["n_layers_D"] + 1) * opt.get("lambda_feat", 10.0)
    feat = sum(weight * (f - r.detach()).abs().mean()
               for fs, rs in zip(pred_fake_g, pred_real) for f, r in zip(fs[:-1], rs[:-1]))
    out = {"G_GAN": lsgan(pred_fake_g, 1.0), "G_GAN_Feat": feat,
           "D_real": lsgan(pred_real, 1.0), "D_fake": lsgan(pred_fake_d, 0.0)}
    out["loss_G"] = out["G_GAN"] + out["G_GAN_Feat"]
    out["loss_D"] = 0.5 * (out["D_fake"] + out["D_real"])
    return out


class Adam:
    """Adam over ``params`` in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, beta1: float,
                 beta2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = list(params), lr, beta1, beta2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def bn_stats(G) -> Dict[str, np.ndarray]:
    """G's BatchNorm running statistics, on the host."""
    return {k: v.detach().cpu().numpy().copy() for k, v in G.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def follow(G, D, transform, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], opt,
           batch_rows: int = None) -> Dict:
    """Train ``G`` and ``D`` (in train mode, in place) over ``batches`` of
    (LR, HR) waveforms, one step each, and return what the check compares:
    each step's losses, the first step's gradient and each leaf's change
    over all the steps, leaf by leaf on the device, keyed by ``G.<name>`` /
    ``D.<name>``.
    ``batch_rows`` keeps only the first rows of each batch (the half-batch
    fault).  G's BatchNorm running statistics after the first step come
    back too, on the host."""
    G.train(), D.train()
    named = [(f"G.{k}", p) for k, p in G.named_parameters()] + \
            [(f"D.{k}", p) for k, p in D.named_parameters()]
    start = {k: p.detach().clone() for k, p in named}
    params = [p for _, p in named]
    adam = Adam(params, opt["lr"], opt["beta1"])
    out: Dict = {"losses": []}
    for i, (lr_audio, hr_audio) in enumerate(batches):
        if batch_rows is not None:
            lr_audio, hr_audio = lr_audio[:batch_rows], hr_audio[:batch_rows]
        with torch.no_grad():
            lr_spec, hr_spec = transform.spectrum(lr_audio), transform.spectrum(hr_audio)
        ls = losses(G, D, lr_spec, hr_spec, opt)
        grads = torch.autograd.grad(ls["loss_G"] + ls["loss_D"], params)
        out["losses"].append({k: float(v.detach()) for k, v in ls.items()})
        if i == 0:
            out["grads"] = {k: g for (k, _), g in zip(named, grads)}
            out["bn_stats"] = bn_stats(G)
        adam.step(grads)
        del ls, grads
    with torch.no_grad():
        out["changes"] = {k: p.detach() - start[k] for k, p in named}
    return out
