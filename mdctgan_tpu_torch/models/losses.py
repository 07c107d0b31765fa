"""GAN objectives: the port of ``mdctgan_tpu/models/losses.py``.

Every function takes the nested multiscale feature lists of
``MultiscaleDiscriminator`` and reduces to a scalar in float32, or in
float64 for float64 features.  A per-sample
weight ``w`` of shape (B,) makes each term the weighted mean over samples of
per-sample means: with 0/1 weights that is the plain mean over the weighted
samples alone, so a padded tail batch gives the losses of the smaller batch.

Under data parallelism (``parallel/mesh.py``) each rank holds some rows of
the global batch, and ``total_weight`` is the global batch's weight: the
ranks' summed sample weights, or their summed rows without weights (a
weight of 1 a row).  Each function then returns this rank's share of the
global loss, its rows' sum divided by that total, so that the shares, and
their gradients, sum over the ranks to the global loss and its gradient.
Without it, the mean is over this call's rows, bit for bit as before.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from mdctgan_tpu_torch.models.layers import lift, reduce_mean

Features = List[List[torch.Tensor]]


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor],
           total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    if w is None and total_weight is None:
        return reduce_mean(x)
    per = x.reshape(x.shape[0], -1).mean(dim=1)
    w = torch.ones_like(per) if w is None else w.to(per.dtype)
    total = (torch.clamp(w.sum(), min=1.0) if total_weight is None
             else total_weight.to(per.dtype))
    return (per * w).sum() / total


def gan_loss(preds: Features, target_is_real: bool, use_lsgan: bool = True,
             sample_weight: Optional[torch.Tensor] = None,
             total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LSGAN (squared error against 0/1) or BCE on probabilities, summed
    over scales; each scale's last element is its patch logit map."""
    target = 1.0 if target_is_real else 0.0
    total = 0.0
    for scale in preds:
        pred = lift(scale[-1])
        if use_lsgan:
            total = total + _wmean((pred - target) ** 2, sample_weight, total_weight)
        else:
            eps = 1e-12
            p = torch.clamp(pred, eps, 1 - eps)
            total = total + _wmean(
                -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)),
                sample_weight, total_weight)
    return total


def feature_matching_loss(pred_fake: Features, pred_real: Features,
                          n_layers_d: int, num_d: int, lambda_feat: float = 10.0,
                          sample_weight: Optional[torch.Tensor] = None,
                          total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 between the fake's and the real's intermediate features (not the
    logits), each weighted 4/(n_layers_d+1) * 1/num_d * lambda_feat; the
    real side is detached."""
    weight = 1.0 / num_d * (4.0 / (n_layers_d + 1)) * lambda_feat
    total = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            target = lift(pred_real[i][j].detach())
            total = total + weight * _wmean(
                torch.abs(lift(pred_fake[i][j]) - target), sample_weight, total_weight)
    return total
