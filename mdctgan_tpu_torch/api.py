"""High-level serving API: ``create_model``, the segment loop that every
serving caller shares (``serve_segments``) and the one-call ``upsample``.

Data-parallel serving runs in one process, as the JAX package's does: one
generator replica per device of a ``parallel.mesh.Mesh`` (``replicate``),
each segment batch split over them, every replica enqueued from the one
thread (launches return at once), and the results gathered on the first
device."""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from mdctgan_tpu_torch.data.dataset import AudioAppDataset
from mdctgan_tpu_torch.device import float32_policy, resolve_device
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.ops.resample import degrade_lr, resample
from mdctgan_tpu_torch.options import as_dict, spectral_config_from_opt
from mdctgan_tpu_torch.parallel.mesh import Mesh
from mdctgan_tpu_torch.train.step import build_inference_fn
from mdctgan_tpu_torch.utils import tracing
from mdctgan_tpu_torch.weights import init_weights

# Segment batches in flight in ``serve_segments``: the host enqueues batch
# i+1 before it waits for batch i, and holds no more.  1 is a synchronous
# loop.
IN_FLIGHT = 2


@dataclasses.dataclass
class Model:
    """A generator with its weights, the spectral transform and the
    inference function, all on ``device``."""

    generator: nn.Module
    transform: SpectralTransform
    inference: Callable
    device: torch.device


def create_model(
    opt,
    device="cuda",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
) -> Model:
    """Inference model from an options dict or a parsed namespace.  Weights
    come from ``state_dict`` (strict load; see ``weights.state_dict_from_jax``
    and ``train/restore.py``) or, without one, from the reference
    initialisation seeded by ``opt["seed"]``.  Raises when ``device`` is
    CUDA and CUDA is absent."""
    dev = resolve_device(device)
    opt = as_dict(opt)
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


def replicate(model: Model, mesh: Mesh) -> List[Model]:
    """One replica of ``model`` per device of ``mesh``, in its order:
    ``model`` itself where it lies on that device (the first time), else a
    copy of its generator moved there, with a transform and an inference
    function of its own."""
    replicas = []
    for dev in mesh.devices:
        if dev == model.device and all(r is not model for r in replicas):
            replicas.append(model)
            continue
        generator = copy.deepcopy(model.generator).to(dev).eval()
        transform = SpectralTransform(model.transform.cfg, dev, model.transform.dtype)
        infer = build_inference_fn(generator, transform,
                                   out_length=model.transform.cfg.segment_length)
        replicas.append(Model(generator, transform, infer, dev))
    return replicas


def serve_segments(model: Union[Model, Sequence[Model]], segments: np.ndarray,
                   batch_size: int,
                   phase: Optional[Callable[[int], torch.Generator]] = None) -> np.ndarray:
    """(N, segment_length) LR segments -> (N, segment_length) SR segments,
    through ``model.inference`` in batches of ``batch_size`` (the last one
    zero-padded); ``phase(i)``, when given, is the pseudo-phase generator of
    the batch that starts at segment ``i`` (the dB mode's; see
    ``SpectralTransform.to_audio``).  On the card each batch goes up from
    pinned memory and comes back into pinned memory without blocking, with
    one event; the host waits for batch i's event only after batch i+1 is enqueued, so at
    most ``IN_FLIGHT`` batches are held and the card need not idle while
    the host prepares and launches the next.  The result is that of a
    synchronous loop.

    ``model`` may be a list of replicas (``replicate``): each batch is then
    split into equal shares, one a replica in order, each drawing its
    pseudo-phase from its own ``phase(i)`` at the batch's shape and keeping
    its rows, so the draws are the one device's; the shares are gathered on
    the first replica's device.  ``batch_size`` must divide by their
    number.

    Traced (``utils/tracing.py``): a span ``serve.batch`` a batch (pin,
    upload, the inference's launches, the download's launch) and
    ``serve.wait`` where the host blocks on a batch's event; the counters
    ``serve.rows`` (segment rows sent to the generator, padding included)
    and ``serve.padded_rows``."""
    replicas = [model] if isinstance(model, Model) else list(model)
    n_rep = len(replicas)
    if batch_size % n_rep:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {n_rep}")
    share = batch_size // n_rep
    first = replicas[0]
    seg = first.transform.cfg.segment_length
    n = len(segments)
    n_pad = (-n) % batch_size
    if n_pad:
        segments = np.concatenate([segments, np.zeros((n_pad, seg), np.float32)])
    segments = np.ascontiguousarray(segments, np.float32)
    out = np.empty((len(segments), seg), np.float32)
    on_card = first.device.type == "cuda"
    pending = collections.deque()

    def drain_one():
        i, host, done = pending.popleft()
        if done is not None:
            with tracing.span("serve.wait"):
                done.synchronize()
        out[i : i + batch_size] = host.numpy()

    tracing.count("serve.rows", len(segments))
    tracing.count("serve.padded_rows", n_pad)
    for i in range(0, len(segments), batch_size):
        with tracing.span("serve.batch"):
            parts = []
            for j, rep in enumerate(replicas):
                x = torch.from_numpy(segments[i + j * share: i + (j + 1) * share])
                if rep.device.type == "cuda":
                    x = x.pin_memory().to(rep.device, non_blocking=True)
                rows = None if n_rep == 1 else (j * share, batch_size)
                _, sr = rep.inference(x, None if phase is None else phase(i), rows)
                parts.append(sr)
            sr_audio = parts[0] if n_rep == 1 else torch.cat(
                [p.to(first.device, non_blocking=True) for p in parts])
            if on_card:
                host = torch.empty(sr_audio.shape, dtype=sr_audio.dtype, pin_memory=True)
                with torch.cuda.device(first.device):  # the event on the copy's stream
                    host.copy_(sr_audio, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
            else:
                host, done = sr_audio, None
        pending.append((i, host, done))
        if len(pending) == IN_FLIGHT:
            drain_one()
    while pending:
        drain_one()
    return out[:n]


def upsample(
    audio: np.ndarray,
    sample_rate: int,
    model: Model,
    is_lr_input: bool = False,
    gen_overlap: int = 0,
    batch_size: int = 8,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """Super-resolve an in-memory waveform: degrade it (or only resample it
    to the HR rate if ``is_lr_input``), segment, infer in batches of
    ``batch_size`` (``serve_segments``), stitch, and crop to the input's
    duration at the HR rate.

    ``mesh``: serve data-parallel over its devices, ``model`` copied to
    each (``replicate``, on every call; a server replicates once and calls
    ``serve_segments``); ``batch_size`` must divide by the mesh size.

    Traced: the root span ``upsample`` a request, with ``upsample.lr``,
    ``upsample.to_host`` (the host waits for the resample),
    ``upsample.segment``, ``serve_segments``' spans and
    ``upsample.stitch``."""
    cfg = model.transform.cfg
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh.size}")
    with tracing.span("upsample"):
        replicas = model if mesh is None else replicate(model, mesh)
        ds = AudioAppDataset(audio, sample_rate, cfg.segment_length, gen_overlap)
        with tracing.span("upsample.lr"):
            raw = torch.from_numpy(ds.raw_audio)[None].to(model.device)
            with torch.inference_mode(), float32_policy():
                if is_lr_input:
                    lr = resample(raw, sample_rate, cfg.hr_sampling_rate)
                else:
                    lr = degrade_lr(raw, sample_rate, cfg.lr_sampling_rate,
                                    cfg.hr_sampling_rate)
        with tracing.span("upsample.to_host"):  # the host waits for the card here
            lr_host = lr[0].cpu().numpy()
        with tracing.span("upsample.segment"):
            segments = ds.segments_of(lr_host)
        sr_segments = serve_segments(replicas, segments, batch_size)
        with tracing.span("upsample.stitch"):
            out_len = int(round(len(ds.raw_audio) * cfg.hr_sampling_rate / sample_rate))
            return ds.stitch(sr_segments)[:out_len]
