"""The train input pipeline: the port of ``mdctgan_tpu/data/pipeline.py``.

A background thread decodes batches on the host (through the native C++
prefetcher for random crops, through ``AudioDataset`` for serial ones) into
a bounded queue, in pinned memory when the model is on the card.
``next()`` copies the batch to the device without blocking the host and
degrades it there: resample to the HR rate, down to the LR rate and back
(``degrade_lr``), optional SNR-calibrated noise from an explicit
``torch.Generator``, and both fixed to ``segment_length``.

The degrade runs in the consumer's thread, on its current stream and under
its float32 policy, not in the worker as the JAX package's does: the
policy's switches (``device.float32_policy``) are process-wide, so a
worker's ``conv1d`` could otherwise run in TF32 while the consumer is
between steps, and a side stream's work would need an event before the
step reads it.  On the card the degrade is a few launches, queued behind
the step like any other.

Under data parallelism (``ranks``; ``parallel/mesh.py``) every rank of a
host reads and degrades the host's whole batch, from the same seeded stream,
and keeps its own rows: the host batch is split over the host's ranks as
the JAX package's one process a host shards its batch over its devices.
The C++ prefetcher's order across its threads is not fixed, so there each
of its ``n_threads`` streams decodes on a thread of its own and the streams
are read in turn (``native.OrderedPrefetcher``), which makes the stream the
same on every rank.
Every host seeds its stream with the same ``seed``, as the JAX package's
hosts do, so hosts given one corpus draw the same rows.  With several
hosts, a batch at a rate other than the probed one is refused, as in the
JAX package.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mdctgan_tpu_torch.data import native
from mdctgan_tpu_torch.data.dataset import AudioDataset, unsupported_note
from mdctgan_tpu_torch.device import resolve_device
from mdctgan_tpu_torch.ops.features import SpectralConfig
from mdctgan_tpu_torch.ops.resample import add_noise_snr, degrade_lr, fix_length, resample
from mdctgan_tpu_torch.parallel import mesh
from mdctgan_tpu_torch.utils import tracing

Degrade = Callable[[torch.Tensor, torch.Generator], Dict[str, torch.Tensor]]


def make_degrade_fn(cfg: SpectralConfig, orig_freq: int, add_noise: bool,
                    snr: float) -> Degrade:
    """``degrade(wave, generator)``: segments (B, T) at ``orig_freq`` on any
    device -> ``{"hr_audio", "lr_audio"}`` at the HR rate, both fixed to
    ``segment_length``, on the same device.  With ``add_noise`` the LR gets
    noise ``snr`` dB under it, drawn from ``generator`` on the CPU."""

    def degrade(wave: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        hr = resample(wave, orig_freq, cfg.hr_sampling_rate)
        lr = degrade_lr(wave, orig_freq, cfg.lr_sampling_rate, cfg.hr_sampling_rate)
        if add_noise:
            lr = add_noise_snr(lr, snr, cfg.segment_length, generator)
        return {"hr_audio": fix_length(hr, cfg.segment_length),
                "lr_audio": fix_length(lr, cfg.segment_length)}

    return degrade


class InputPipeline:
    """Batches of ``batch_size`` degraded segments on ``device``, read
    ahead by a background thread (``queue_size`` batches); with ``ranks``,
    this rank's rows of each host batch of ``batch_size``."""

    def __init__(self, dataset: AudioDataset, cfg: SpectralConfig, batch_size: int,
                 orig_freq: Optional[int] = None, add_noise: bool = False,
                 snr: float = 55.0, seed: int = 42, queue_size: int = 4,
                 device="cuda", n_threads: int = 4, ranks: Optional[mesh.Ranks] = None):
        self.dataset = dataset
        self.ranks = ranks
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        if orig_freq is None:
            # the first file that can be probed, past undecodable ones
            for j in range(len(dataset)):
                try:
                    orig_freq, _ = dataset._probe(j)
                    break
                except Exception:
                    continue
            if orig_freq is None:
                raise RuntimeError(
                    f"no decodable audio files in dataset ({len(dataset)} entries, "
                    "all failed to probe)" + unsupported_note(dataset.files))
        self.orig_freq = orig_freq
        self._add_noise, self._snr = add_noise, snr
        # one degrade per observed sample rate, the probed one first
        self._degrade_cache: Dict[int, Degrade] = {}
        self._degrade_for(orig_freq)
        self._generator = torch.Generator().manual_seed(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._prefetcher = None
        # the C++ prefetcher crops at random; serial mode stays in Python
        if not dataset.serial and native.load_library() is not None:
            make = native.NativePrefetcher if ranks is None else native.OrderedPrefetcher
            self._prefetcher = make(dataset.files, dataset.segment_length,
                                    n_threads=n_threads, queue_cap=queue_size * batch_size,
                                    seed=seed)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _degrade_for(self, sr: int) -> Degrade:
        fn = self._degrade_cache.get(int(sr))
        if fn is None:
            fn = make_degrade_fn(self.cfg, int(sr), self._add_noise, self._snr)
            self._degrade_cache[int(sr)] = fn
        return fn

    def _host_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """(segments, each one's rate): ``segment_length`` frames at each
        file's own rate, so mixed-rate batches still stack."""
        if self._prefetcher is not None:
            segs, rates = zip(*(self._prefetcher.next() for _ in range(self.batch_size)))
            return np.stack(segs), np.asarray(rates, np.int64)
        return self.dataset.sample_batch_rates(self.batch_size)

    def _degrade_batch(self, wave: torch.Tensor, rates: np.ndarray) -> Dict[str, torch.Tensor]:
        """Each row at its own rate.  A homogeneous batch runs one degrade;
        a mixed one runs the whole batch once per rate, each from the same
        generator state (one noise draw, as the JAX package's one key), and
        picks each row from its rate's result."""
        uniq = np.unique(rates)
        if self.ranks is not None and self.ranks.hosts > 1 and (
                len(uniq) > 1 or int(uniq[0]) != self.orig_freq):
            raise ValueError(
                f"mixed/non-probed sample rates {sorted(uniq.tolist())} are unsupported "
                f"under multi-host training (pipeline probed {self.orig_freq} Hz); "
                "single-host runs handle them")
        if len(uniq) == 1:
            return self._degrade_for(int(uniq[0]))(wave, self._generator)
        start = self._generator.get_state()
        out: Optional[Dict[str, torch.Tensor]] = None
        for r in uniq:
            self._generator.set_state(start)
            d = self._degrade_for(int(r))(wave, self._generator)
            if out is None:
                out = d
            else:
                mask = torch.from_numpy((rates == r).reshape(-1, 1)).to(wave.device)
                out = {k: torch.where(mask, d[k], out[k]) for k in d}
        return out

    def _work(self) -> None:
        while not self._stop.is_set():
            try:
                host, rates = self._host_batch()
                wave = torch.from_numpy(host)
                if self._pin:
                    wave = wave.pin_memory()
            except StopIteration:
                break
            except Exception as e:  # surfaced by __next__
                self._error = e
                break
            while not self._stop.is_set():
                try:
                    self._queue.put((wave, rates), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def _next_host(self) -> Tuple[torch.Tensor, np.ndarray]:
        """The next host batch, blocking until the worker has one: the span
        ``pipeline.queue_wait``; the counters ``pipeline.gets`` and
        ``pipeline.depth`` (batches ready before each get)."""
        depth = self._queue.qsize()
        tracing.count("pipeline.gets")
        tracing.count("pipeline.depth", depth)
        with tracing.span("pipeline.queue_wait"):
            while True:
                if self._queue.empty() and self._error is not None:
                    raise RuntimeError("input pipeline worker failed") from self._error
                if self._stop.is_set() and self._queue.empty():
                    raise StopIteration
                try:
                    return self._queue.get(timeout=1.0)
                except queue.Empty:
                    if not self._thread.is_alive():
                        if self._error is not None:
                            raise RuntimeError("input pipeline worker failed") from self._error
                        raise StopIteration

    def __next__(self) -> Dict[str, torch.Tensor]:
        """The next batch on the device: ``{"hr_audio", "lr_audio"}``, each
        (batch_size, segment_length) float32, or this rank's rows of it."""
        wave, rates = self._next_host()
        with tracing.span("pipeline.degrade"), torch.no_grad():
            batch = self._degrade_batch(wave.to(self.device, non_blocking=True), rates)
            return mesh.put_global_batch(batch, self.ranks)

    def close(self) -> None:
        """Stop the worker, then destroy the prefetcher, or leak it where the
        worker is still blocked inside it (destroying it there would free it
        under a live call)."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._prefetcher is not None:
            if self._thread.is_alive():
                self._prefetcher.leak()
            else:
                self._prefetcher.close()
