"""ctypes binding of the repository's audio I/O library (``native/audioio``).

A copy of ``mdctgan_tpu/data/native.py``: ``info``, ``read`` and
``write_wav16`` through ``libaudioio.so`` (WAV, FLAC, AIFF, and
mp3/ogg/opus/m4a where their system libraries load), with the stdlib WAV
reader and writer where the library is not there, and ``NativePrefetcher``,
the library's multi-threaded random-crop segment decoder that the input
pipeline reads from, and ``OrderedPrefetcher``, its streams in a fixed
order.  The library is loaded, and built with ``make`` if it is missing,
at the first call, never at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
import wave
from typing import List, Optional, Tuple

import numpy as np

_LIB_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                        "native", "audioio"))
_LIB_PATH = os.path.join(_LIB_DIR, "libaudioio.so")

_lib: Optional[ctypes.CDLL] = None


def _try_build() -> None:
    try:
        subprocess.run(["make", "-s"], cwd=_LIB_DIR, check=True,
                       capture_output=True, timeout=120)
    except subprocess.CalledProcessError as e:
        # a failed build leaves only the WAV reader: say why
        tail = (e.stderr or b"").decode("utf-8", "replace").strip().splitlines()
        warnings.warn("native audioio build failed; only WAV can be read. "
                      "Compiler said: " + " | ".join(tail[-4:]),
                      RuntimeWarning, stacklevel=2)
    except (OSError, subprocess.TimeoutExpired):
        pass  # no `make`: the stdlib WAV reader is the intended path


def load_library(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it is not there (and cannot be
    built)."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and build_if_missing:
        _try_build()
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    u32p, u64p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.audioio_info.argtypes = [ctypes.c_char_p, u32p, u32p, u64p]
    lib.audioio_info.restype = ctypes.c_int
    lib.audioio_read.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                                 f32p, u32p]
    lib.audioio_read.restype = ctypes.c_int
    lib.audioio_write_wav16.argtypes = [ctypes.c_char_p, f32p, ctypes.c_uint64,
                                        ctypes.c_uint32]
    lib.audioio_write_wav16.restype = ctypes.c_int
    lib.audioio_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.audioio_prefetcher_create.restype = ctypes.c_void_p
    lib.audioio_prefetcher_next.argtypes = [ctypes.c_void_p, f32p, u32p]
    lib.audioio_prefetcher_next.restype = ctypes.c_int
    lib.audioio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.audioio_prefetcher_destroy.restype = None
    _lib = lib
    return lib


# --------------------------------------------------------------------------
# stdlib reader (16/24/32-bit PCM WAV)
# --------------------------------------------------------------------------

def _py_info(path: str) -> Tuple[int, int, int]:
    with wave.open(path, "rb") as w:
        return w.getframerate(), w.getnchannels(), w.getnframes()


def _py_read(path: str, offset: int, frames: int) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr, ch, total = w.getframerate(), w.getnchannels(), w.getnframes()
        sw = w.getsampwidth()
        w.setpos(min(offset, total))
        raw = w.readframes(min(frames, total - min(offset, total)))
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        data = v.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    data = data.reshape(-1, ch)[:, 0]  # mono: channel 0
    if len(data) < frames:
        data = np.pad(data, (0, frames - len(data)))
    return data, sr


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _has_capability(symbol: str) -> bool:
    """An optional decoder's flag as the library exports it; False without
    the library or where it predates the flag."""
    lib = load_library()
    if lib is None:
        return False
    try:
        fn = getattr(lib, symbol)
    except AttributeError:
        return False
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return bool(fn())


def has_mp3() -> bool:
    """True when the library decodes mp3 (system libmpg123 found)."""
    return _has_capability("audioio_has_mp3")


def has_vorbis() -> bool:
    """True when the library decodes Ogg/Vorbis (libvorbisfile found)."""
    return _has_capability("audioio_has_vorbis")


def has_opus() -> bool:
    """True when the library decodes Ogg/Opus (libopus and libogg found)."""
    return _has_capability("audioio_has_opus")


def has_ffmpeg() -> bool:
    """True when the library decodes m4a/aac/wma (ffmpeg 5.x found)."""
    return _has_capability("audioio_has_ffmpeg")


def info(path: str) -> Tuple[int, int, int]:
    """(sample_rate, channels, num_frames)."""
    lib = load_library()
    if lib is not None:
        sr, ch, nf = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint64()
        if lib.audioio_info(path.encode(), sr, ch, nf) == 0:
            return sr.value, ch.value, nf.value
    return _py_info(path)


def read(path: str, offset: int = 0, frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Mono float32 samples and the sample rate; zero-padded past the end."""
    if frames is None:
        _, _, total = info(path)
        frames = total - offset
    lib = load_library()
    if lib is not None:
        out = np.empty(frames, np.float32)
        sr = ctypes.c_uint32()
        rc = lib.audioio_read(path.encode(), offset, frames,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), sr)
        if rc == 0:
            return out, sr.value
    return _py_read(path, offset, frames)


def write_wav16(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Mono 16-bit PCM WAV: samples scaled by 32768, rounded to nearest and
    clipped."""
    data = np.ascontiguousarray(data, np.float32).ravel()
    lib = load_library()
    if lib is not None:
        rc = lib.audioio_write_wav16(path.encode(),
                                     data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                     len(data), sample_rate)
        if rc == 0:
            return
    pcm = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


class NativePrefetcher:
    """The library's multi-threaded segment prefetcher: ``n_threads`` C++
    threads decode ``segment_frames`` frames at a random offset of a random
    file (seeded by ``seed``; the order across threads is not fixed) into a
    queue of ``queue_cap`` segments.  ``next()`` raises ``StopIteration``
    when no file can be decoded."""

    def __init__(self, files: List[str], segment_frames: int,
                 n_threads: int = 2, queue_cap: int = 64, seed: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native audioio library unavailable")
        self._lib = lib
        self.segment_frames = segment_frames
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        self._handle = lib.audioio_prefetcher_create(
            arr, len(files), segment_frames, n_threads, queue_cap, seed)
        if not self._handle:
            raise RuntimeError("failed to create prefetcher")

    def next(self) -> Tuple[np.ndarray, int]:
        out = np.empty(self.segment_frames, np.float32)
        sr = ctypes.c_uint32()
        rc = self._lib.audioio_prefetcher_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), sr)
        if rc != 0:
            raise StopIteration
        return out, sr.value

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.audioio_prefetcher_destroy(self._handle)
            self._handle = None

    def leak(self) -> None:
        """Abandon the C++ object without destroying it, for a shutdown in
        which a thread may still be blocked inside ``next()``: destroying it
        there is a use-after-free, and so would be ``__del__`` without this.
        The process's exit reclaims it."""
        self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class OrderedPrefetcher:
    """The streams of a ``NativePrefetcher`` of ``n_threads`` threads (the
    library seeds its thread ``i`` with ``seed + i``), each decoded by a
    one-thread ``NativePrefetcher`` of its own and read in turn: as many
    decode threads, in an order that ``seed`` fixes, so that processes
    reading one corpus with one seed read the same segments."""

    def __init__(self, files: List[str], segment_frames: int,
                 n_threads: int = 2, queue_cap: int = 64, seed: int = 0):
        n = max(1, n_threads)
        self._parts: List[NativePrefetcher] = []
        try:
            for i in range(n):
                self._parts.append(NativePrefetcher(
                    files, segment_frames, n_threads=1,
                    queue_cap=max(1, -(-queue_cap // n)), seed=seed + i))
        except Exception:
            self.close()
            raise
        self._turn = 0

    def next(self) -> Tuple[np.ndarray, int]:
        part = self._parts[self._turn]
        self._turn = (self._turn + 1) % len(self._parts)
        return part.next()

    def close(self) -> None:
        for part in self._parts:
            part.close()

    def leak(self) -> None:
        """``NativePrefetcher.leak`` of every stream."""
        for part in self._parts:
            part.leak()
