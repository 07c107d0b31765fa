"""In-memory clip segmentation and stitching (the serving side of
``mdctgan_tpu/data/dataset.py``; file reading is not ported)."""

from __future__ import annotations

import numpy as np


class AudioAppDataset:
    """A waveform array and its sample rate -> overlapped fixed-length
    segments, and back.  No DC shift (the reference's in-memory dataset has
    none)."""

    def __init__(self, audio: np.ndarray, sample_rate: int, segment_length: int,
                 overlap: int = 0):
        self.segment_length = int(segment_length)
        self.overlap = int(overlap)
        self.in_sampling_rate = sample_rate
        self.raw_audio = np.asarray(audio, np.float32).reshape(-1)
        self.audio_len = len(self.raw_audio)
        self._short_segmented = None

    def segments_of(self, audio: np.ndarray) -> np.ndarray:
        """Unfold into (n_segments, segment_length) with the reference's
        padding.  The branch is decided from THIS signal's length (the caller
        passes the resampled LR, whose length differs from the raw one) and
        recorded for ``stitch``."""
        seg, ov = self.segment_length, self.overlap
        length = len(audio)
        self._short_segmented = length < seg
        if length >= seg:
            n = int(np.ceil(length / seg))
            padded = np.pad(audio, (ov, seg * n - length + ov))
            stride = seg - ov
            count = (len(padded) - seg) // stride + 1
            idx = np.arange(count)[:, None] * stride + np.arange(seg)[None, :]
            return padded[idx]
        return np.pad(audio, (0, seg - length))[None, :]

    def stitch(self, segments: np.ndarray) -> np.ndarray:
        """The inverse of ``segments_of``.  A short clip's lone segment was
        padded at the tail only, so it is not edge-halved."""
        short = self._short_segmented
        if short is None:  # stitch() without segments_of(): raw-length guess
            short = self.audio_len < self.segment_length
        if self.overlap == 0 or short:
            return np.asarray(segments).reshape(-1)
        return overlap_add_segments(
            np.asarray(segments), self.segment_length, self.overlap)


def overlap_add_segments(segments: np.ndarray, segment_length: int,
                         overlap: int) -> np.ndarray:
    """Edge-halving overlap-add of generated segments; identity concat when
    overlap == 0."""
    if overlap == 0:
        return segments.reshape(-1)
    seg = segments.copy()
    seg[..., :overlap] *= 0.5
    seg[..., -overlap:] *= 0.5
    stride = segment_length - overlap
    n = seg.shape[0]
    out = np.zeros((n - 1) * stride + segment_length, seg.dtype)
    for i in range(n):
        out[i * stride : i * stride + segment_length] += seg[i]
    return out[overlap:-overlap]
