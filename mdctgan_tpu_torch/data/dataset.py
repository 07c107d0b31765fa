"""Audio file lists, the random-crop train dataset, whole-file test
datasets, segmentation and stitching: a copy of
``mdctgan_tpu/data/dataset.py``.  The host only decodes; resampling,
degradation and noise run on the model's device (``data/pipeline.py``)."""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np

from mdctgan_tpu_torch.data import native

# decoded by the library's own readers, always (AIFF is big-endian PCM)
AUDIO_EXTS = (".wav", ".flac", ".aiff", ".aif")
# decoded through system libraries when the library finds them:
# (extensions, probe on ``native``, library name for the hint)
_OPTIONAL_DECODERS = (
    ((".mp3",), "has_mp3", "libmpg123"),
    ((".ogg",), "has_vorbis", "libvorbisfile"),
    ((".opus",), "has_opus", "libopus+libogg"),
    ((".m4a", ".aac", ".wma"), "has_ffmpeg", "ffmpeg 5.x libraries"),
)
# formats the reference decodes that this host may not: each is rejected
# up front, with a hint, when its system library is absent
UNSUPPORTED_AUDIO_EXTS = (".mp3", ".ogg", ".opus", ".m4a", ".aac", ".wma")


def supported_exts() -> Tuple[str, ...]:
    """The extensions this host decodes."""
    exts = AUDIO_EXTS
    for opt_exts, probe, _ in _OPTIONAL_DECODERS:
        if getattr(native, probe)():
            exts = exts + opt_exts
    return exts


def unsupported_note(files: List[str]) -> str:
    """': found N .ogg (+...) files — not decodable (convert to WAV/FLAC)'
    when ``files`` holds formats this host cannot decode, else ''."""
    supported = supported_exts()
    counts: dict = {}
    for f in files:
        ext = os.path.splitext(f)[1].lower()
        if ext in UNSUPPORTED_AUDIO_EXTS and ext not in supported:
            counts[ext] = counts.get(ext, 0) + 1
    if not counts:
        return ""
    parts = ", ".join(f"{n} {e}" for e, n in sorted(counts.items()))
    hint = " (convert to WAV or FLAC"
    for opt_exts, _, lib in _OPTIONAL_DECODERS:
        if any(e in counts for e in opt_exts):
            hint += f"; {'/'.join(opt_exts)} needs the system {lib}"
    hint += ")"
    return (f": found {parts} file(s) — these formats are not decodable "
            f"by this framework{hint}")


def list_audio_files(path: str, max_files: Optional[int] = None) -> List[str]:
    """A CSV index (one path per cell, relative to the CSV's directory) or a
    recursive directory walk, sorted."""
    if os.path.isdir(path):
        supported = supported_exts()
        files, skipped = [], []
        for root, _, names in os.walk(path):
            for name in sorted(names):
                ext = os.path.splitext(name)[1].lower()
                if ext in supported:
                    files.append(os.path.join(root, name))
                elif ext in UNSUPPORTED_AUDIO_EXTS:
                    skipped.append(name)
        files.sort()
        if not files and skipped:
            raise FileNotFoundError(
                f"no decodable audio files under {path}" + unsupported_note(skipped))
        if skipped:
            print(f"[data] skipping {len(skipped)} unsupported audio "
                  f"file(s) under {path}{unsupported_note(skipped)}", flush=True)
    else:
        root = os.path.dirname(path)
        with open(path, "r") as f:
            files = [os.path.join(root, item) for row in csv.reader(f)
                     for item in row if item]
    if max_files is not None:
        files = files[: int(max_files)]
    if not files:
        raise FileNotFoundError(f"no audio files found under {path}")
    return files


class AudioDataset:
    """Random-crop training dataset over a file list.

    ``sample()`` returns ``segment_length`` frames at the file's own rate
    from an offset drawn by ``np.random.default_rng(seed)``, with the same
    draws in the same order as the JAX package, and the file's rate.
    ``serial`` takes the files in order instead of at random;
    ``deterministic`` fixes each file's offset, drawn from
    ``default_rng((seed, file index))``.  A file that cannot be read is
    skipped for the next one."""

    def __init__(self, index_path: str, segment_length: int, seed: int = 42,
                 max_files: Optional[int] = None, serial: bool = False,
                 deterministic: bool = False):
        self.files = list_audio_files(index_path, max_files)
        self.segment_length = int(segment_length)
        self.serial = serial
        self.deterministic = deterministic
        self._cursor = 0
        self._len_cache: dict = {}
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.files)

    def _probe(self, idx: int) -> Tuple[int, int]:
        """(rate, frames) of file ``idx``, read once."""
        if idx not in self._len_cache:
            sr, _, nframes = native.info(self.files[idx])
            self._len_cache[idx] = (sr, nframes)
        return self._len_cache[idx]

    def sample(self, idx: Optional[int] = None) -> Tuple[np.ndarray, int]:
        if idx is None:
            if self.serial:
                idx = self._cursor
                self._cursor = (self._cursor + 1) % len(self.files)
            else:
                idx = int(self._rng.integers(0, len(self.files)))
        for attempt in range(len(self.files)):
            j = (idx + attempt) % len(self.files)
            try:
                sr, nframes = self._probe(j)
                max_start = nframes - self.segment_length
                if max_start <= 0:
                    off = 0
                elif self.deterministic:
                    off = int(np.random.default_rng((self._seed, j)).integers(0, max_start))
                else:
                    off = int(self._rng.integers(0, max_start))
                return native.read(self.files[j], off, self.segment_length)
            except Exception:
                continue  # an unreadable file: try the next
        raise RuntimeError("no decodable audio files in dataset" + unsupported_note(self.files))

    def sample_batch_rates(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """(segments (B, segment_length), each one's rate (B,))."""
        segs, rates = zip(*(self.sample() for _ in range(batch_size)))
        return np.stack(segs), np.asarray(rates, np.int64)


class AudioTestDataset:
    """One file, read whole and DC-shifted by ``1e-4 - mean``, cut into
    overlapped fixed-length segments and stitched back."""

    def __init__(self, path: str, segment_length: int, overlap: int = 0):
        raw, sr = native.read(path)
        self._init_from_array(raw, sr, segment_length, overlap)

    def _init_from_array(self, raw: np.ndarray, sr: int, segment_length: int,
                         overlap: int, dc_shift: bool = True) -> None:
        self.segment_length = int(segment_length)
        self.overlap = int(overlap)
        self.in_sampling_rate = sr
        raw = np.asarray(raw, np.float32).reshape(-1)
        self.raw_audio = raw + (1e-4 - raw.mean()) if dc_shift else raw
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


class AudioAppDataset(AudioTestDataset):
    """A waveform array and its sample rate in place of a file; no DC shift
    (the reference's in-memory dataset has none)."""

    def __init__(self, audio: np.ndarray, sample_rate: int, segment_length: int,
                 overlap: int = 0):
        self._init_from_array(audio, sample_rate, segment_length, overlap,
                              dc_shift=False)


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
