"""Serving a request: the LR waveform resampled to the HR rate, cut into
segments (zero-padded at the end), each segment's normalised spectrum
through the generator (eval mode), its LR band damped by 1e-3 and the LR
spectrum added (fit_residual), synthesised, and the segments concatenated
and cropped to the input's duration at the HR rate."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from perfbench.reference.models import g_input
from perfbench.reference.transform import resample


def segments_of(x: torch.Tensor, seg: int) -> torch.Tensor:
    """(T,) -> (ceil(T / seg), seg), the last zero-padded (one segment for
    a short clip)."""
    n = max(1, math.ceil(x.shape[-1] / seg))
    return torch.nn.functional.pad(x, (0, n * seg - x.shape[-1])).reshape(n, seg)


@torch.no_grad()
def upsample_many(waves: Sequence[np.ndarray], rate_in: int, G, transform, opt,
                  device, batch: int) -> List[np.ndarray]:
    """Each LR waveform of ``waves`` (at ``rate_in``) -> its SR waveform
    at ``hr_sampling_rate``, the segments of all of them run through ``G``
    in batches of ``batch``."""
    hr, seg = opt["hr_sampling_rate"], opt["segment_length"]
    low = float(opt["norm_range"][0])
    up_ratio = opt["hr_sampling_rate"] / opt["lr_sampling_rate"]
    G.eval()
    parts = [segments_of(resample(torch.as_tensor(w, device=device)[None], rate_in, hr)[0], seg)
             for w in waves]
    segs = torch.cat(parts)
    out = torch.empty_like(segs)
    for i in range(0, len(segs), batch):
        spec = transform.spectrum(segs[i:i + batch])
        sr = G(g_input(spec, low))
        lr_part = int(sr.shape[-1] / up_ratio)
        sr = torch.cat((sr[..., :lr_part] * 1e-3, sr[..., lr_part:]), dim=-1) + spec
        out[i:i + batch] = transform.audio(sr)[..., :seg]
    result, at = [], 0
    for w, p in zip(waves, parts):
        n_out = int(round(len(w) * hr / rate_in))
        result.append(out[at:at + len(p)].reshape(-1)[:n_out].cpu().numpy())
        at += len(p)
    return result
