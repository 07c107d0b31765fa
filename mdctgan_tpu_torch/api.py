"""High-level serving API: ``create_model`` and the one-call ``upsample``."""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from mdctgan_tpu_torch.data.dataset import AudioAppDataset
from mdctgan_tpu_torch.device import float32_policy, resolve_device
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.ops.resample import degrade_lr, resample
from mdctgan_tpu_torch.options import spectral_config_from_opt
from mdctgan_tpu_torch.train.step import build_inference_fn
from mdctgan_tpu_torch.weights import init_weights


@dataclasses.dataclass
class Model:
    """A generator with its weights, the spectral transform and the
    inference function, all on ``device``."""

    generator: nn.Module
    transform: SpectralTransform
    inference: Callable
    device: torch.device


def create_model(
    opt: Mapping,
    device="cuda",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
) -> Model:
    """Inference model from an options dict.  Weights come from
    ``state_dict`` (strict load; see ``weights.state_dict_from_jax``) or,
    without one, from the reference initialisation seeded by ``opt["seed"]``.
    Raises when ``device`` is CUDA and CUDA is absent."""
    dev = resolve_device(device)
    cfg = spectral_config_from_opt(opt)
    transform = SpectralTransform(cfg, dev)
    generator = build_generator(opt)
    if state_dict is None:
        init_weights(generator, torch.Generator().manual_seed(int(opt.get("seed", 42))))
    else:
        generator.load_state_dict(state_dict, strict=True)
    generator = generator.to(dev).eval()
    infer = build_inference_fn(generator, transform, out_length=cfg.segment_length)
    return Model(generator, transform, infer, dev)


def upsample(
    audio: np.ndarray,
    sample_rate: int,
    model: Model,
    is_lr_input: bool = False,
    gen_overlap: int = 0,
    batch_size: int = 8,
) -> np.ndarray:
    """Super-resolve an in-memory waveform: degrade it (or only resample it
    to the HR rate if ``is_lr_input``), segment, infer in batches of
    ``batch_size`` (the last one zero-padded), stitch, and crop to the input's
    duration at the HR rate."""
    cfg = model.transform.cfg
    ds = AudioAppDataset(audio, sample_rate, cfg.segment_length, gen_overlap)
    raw = torch.from_numpy(ds.raw_audio)[None].to(model.device)
    with torch.inference_mode(), float32_policy():
        if is_lr_input:
            lr = resample(raw, sample_rate, cfg.hr_sampling_rate)
        else:
            lr = degrade_lr(raw, sample_rate, cfg.lr_sampling_rate, cfg.hr_sampling_rate)
    segments = ds.segments_of(lr[0].cpu().numpy())
    n = len(segments)
    n_pad = (-n) % batch_size
    if n_pad:
        segments = np.concatenate(
            [segments, np.zeros((n_pad, cfg.segment_length), np.float32)])
    outs = []
    for i in range(0, len(segments), batch_size):
        x = torch.from_numpy(segments[i : i + batch_size]).to(model.device)
        _, sr_audio = model.inference(x)
        outs.append(sr_audio[..., : cfg.segment_length].cpu().numpy())
    sr_segments = np.concatenate(outs)[:n]
    out_len = int(round(len(ds.raw_audio) * cfg.hr_sampling_rate / sample_rate))
    return ds.stitch(sr_segments)[:out_len]
