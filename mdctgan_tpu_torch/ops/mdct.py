"""MDCT / IMDCT as plain matrix products.

The transform is the real MDCT

    X[k] = sum_n  x[n] w[n] cos( (2*pi/N) * (n + 1/2 + N/4) * (k + 1/2) )

for ``n in [0, N)`` and ``k in [0, N/2)``: a (frames, N) @ (N, N/2) product
against a cosine matrix with the analysis window folded in.  The matrices are
built on the host in float64 and cast once.  The inverse is the product with
``(4/N) * (w * C)^T`` followed by the overlap-add of adjacent half-frames.

``mdct``/``imdct`` are the framed products at any framing the JAX package
builds (``win_length <= n_fft``, any hop forward, ``win % hop == 0`` inverse,
centred or not); by default hop = win/2, centred, as the plain versions of
the serving kernels (``ops/mdct_kernels.py``) call them.  The
``MDCT``/``IMDCT`` classes hold a configuration's matrices and count each
call of this matmul form in ``MATMULS``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mdctgan_tpu_torch.ops.window import kbd_window


@functools.lru_cache(maxsize=16)
def _mdct_matrix_f64(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2, dtype=np.float64)[None, :]
    return np.cos((2.0 * np.pi / n_fft) * (n + 0.5 + n_fft / 4.0) * (k + 0.5))


def mdct_matrix(
    n_fft: int, window: Optional[np.ndarray] = None, dtype=np.float32
) -> np.ndarray:
    """(N, N/2) forward-MDCT matrix with the analysis window folded in."""
    m = _mdct_matrix_f64(n_fft)
    if window is not None:
        w = np.zeros(n_fft, dtype=np.float64)
        w[: len(window)] = np.asarray(window, dtype=np.float64)
        m = w[:, None] * m
    return m.astype(dtype)


def frame_signal(
    signal: torch.Tensor, win_length: int, hop_length: int, center: bool = True
) -> torch.Tensor:
    """Slice ``(..., T)`` into overlapped windows ``(..., F, win_length)``.

    ``center=True`` zero-pads ``hop`` at both ends, plus end padding up to a
    multiple of ``hop`` (the reference's framing); ``center=False`` pads the
    end only.  Any hop: ``unfold`` is the JAX package's chunk concatenation
    where ``win % hop == 0`` and its gather elsewhere."""
    t = signal.shape[-1]
    start_pad = hop_length if center else 0
    end_pad = start_pad + (-t) % hop_length
    signal = F.pad(signal, (start_pad, end_pad))
    return signal.unfold(-1, win_length, hop_length)


def n_frames(t: int, win_length: int, hop_length: int, center: bool = True) -> int:
    """Frames that ``frame_signal`` cuts from ``t`` samples."""
    start_pad = hop_length if center else 0
    total = t + 2 * start_pad + (-t) % hop_length
    return (total - win_length) // hop_length + 1


def overlap_add(frames: torch.Tensor, hop_length: int, center: bool = True) -> torch.Tensor:
    """Overlap-add of ``(..., F, win)`` frames back to a signal.  With
    ``center=True`` the half window that the forward padded in is cropped
    at each end: at hop = win/2 output chunk ``c`` is ``frames[c, hop:] +
    frames[c+1, :hop]``, ``(F-1)*hop`` samples.  Any ``win % hop == 0``;
    other hops raise ``NotImplementedError``, as in the JAX package."""
    win_length = frames.shape[-1]
    if win_length == 2 * hop_length and center:
        out = frames[..., :-1, hop_length:] + frames[..., 1:, :hop_length]
        return out.reshape(*out.shape[:-2], -1)
    if win_length % hop_length:
        raise NotImplementedError("overlap_add requires win_length % hop_length == 0")
    ratio = win_length // hop_length
    split = frames.reshape(*frames.shape[:-1], ratio, hop_length)
    # chunk c sums split[c - i, i] over the i in range(ratio) with c - i a frame
    out = sum(F.pad(split[..., i, :], (0, 0, i, ratio - 1 - i)) for i in range(ratio))
    out = out.reshape(*out.shape[:-2], -1)
    if center:
        out = out[..., win_length // 2 : -(win_length // 2)]
    return out


def spectro_matrix(n_fft: int, device="cpu", dtype=torch.float32,
                   win_length: Optional[int] = None) -> torch.Tensor:
    """The (win, N/2) analysis matrix, the KBD window of ``win_length``
    (default N) folded in (float64 build): the rows ``[:win]`` of the
    (N, N/2) matrix of a window zero-padded to N."""
    win = win_length or n_fft
    m = mdct_matrix(n_fft, kbd_window(win), np.float64)[:win]
    return torch.as_tensor(np.ascontiguousarray(m), dtype=dtype, device=device)


def synth_matrix(n_fft: int, device="cpu", dtype=torch.float32,
                 win_length: Optional[int] = None) -> torch.Tensor:
    """The (N/2, win) synthesis matrix ``(4/N) (w C[:win])^T`` (float64
    build), the KBD window of ``win_length`` (default N)."""
    win = win_length or n_fft
    m = mdct_matrix(n_fft, kbd_window(win), np.float64)[:win]
    return torch.as_tensor(np.ascontiguousarray((4.0 / n_fft) * m.T), dtype=dtype,
                           device=device)


def fft_tables(n_fft: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """The FFT kernels' window and twiddles in one flat tensor (float64
    build, cast once).  With M = N/2 and Q = N/4, complex values interleaved
    (re, im), in this order:

    ========  =====  ==========================================
    window    N      the KBD window ``w[n]``
    pre       Q      ``exp(-i pi (m + 1/4) / M)``
    roots     Q/2    ``exp(-2 i pi k / Q)``, the FFT's twiddles
    post      Q      ``exp(-i pi m / M)``
    post_inv  Q      ``(2/M) exp(-i pi m / M)``: the inverse's 4/N folded in
    ========  =====  ==========================================

    The forward (fold, ``pre``, Q-point FFT, ``post``, unpack) equals
    ``frame @ spectro_matrix(N)``; the inverse (``pre``, FFT, ``post_inv``,
    unpack, unfold, window) equals ``X @ synth_matrix(N)``."""
    if n_fft % 8:
        raise ValueError(f"fft_tables: n_fft must be a multiple of 8, got {n_fft}")
    m, q = n_fft // 2, n_fft // 4
    j = np.arange(q, dtype=np.float64)
    post = np.exp(-1j * np.pi * j / m)
    parts = [
        np.asarray(kbd_window(n_fft), dtype=np.float64),
        np.exp(-1j * np.pi * (j + 0.25) / m),
        np.exp(-2j * np.pi * j[: q // 2] / q),
        post,
        (2.0 / m) * post,
    ]
    flat = np.concatenate([
        p if p.dtype == np.float64 else np.stack([p.real, p.imag], -1).reshape(-1)
        for p in parts
    ])
    return torch.as_tensor(flat, dtype=dtype, device=device)


def mdct(signal: torch.Tensor, mat: torch.Tensor, hop_length: Optional[int] = None,
         center: bool = True) -> torch.Tensor:
    """MDCT ``(..., T)`` -> ``(..., F, N/2)``: the framed product with
    ``mat`` (win, N/2) from ``spectro_matrix``; hop defaults to win/2."""
    win = mat.shape[0]
    return torch.matmul(frame_signal(signal, win, hop_length or win // 2, center), mat)


def imdct(spectrum: torch.Tensor, synth: torch.Tensor, hop_length: Optional[int] = None,
          center: bool = True) -> torch.Tensor:
    """Inverse MDCT ``(..., F, N/2)`` -> waveform: the product with ``synth``
    (N/2, win) from ``synth_matrix``, then ``overlap_add`` (centred:
    ``(F-1)*hop`` samples); hop defaults to win/2."""
    win = synth.shape[1]
    return overlap_add(torch.matmul(spectrum, synth), hop_length or win // 2, center)


# Calls of the matmul form (``MDCT``/``IMDCT``, on any device) since the last
# ``reset_matmul_counts()``.  The matmul form is a library product: it serves
# every configuration that kernels K1/K2 (``ops/mdct_kernels.py``, counted in
# their own ``LAUNCHES``) do not, as the JAX package's XLA matmul does.
MATMULS = {"mdct_matmul": 0, "imdct_matmul": 0}


def reset_matmul_counts() -> None:
    for key in MATMULS:
        MATMULS[key] = 0


class MDCT:
    """Forward MDCT, the matmul form: waveform ``(..., T)`` -> spectrum
    ``(..., F, n_fft//2)``, KBD window of ``win_length`` (default N), any
    hop (default win/2), centre-padded or not.  One framed product with the
    (win, N/2) matrix ``kernel``."""

    def __init__(self, n_fft: int = 512, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, center: bool = True,
                 device="cpu", dtype=torch.float32):
        self.n_fft = n_fft
        self.win_length = int(win_length or n_fft)
        self.hop_length = int(hop_length or self.win_length // 2)
        self.center = center
        if self.win_length > n_fft:
            raise ValueError("win_length must be <= n_fft")
        if self.hop_length > self.win_length:
            raise ValueError("hop_length must be <= win_length")
        self.kernel = spectro_matrix(n_fft, device, dtype, self.win_length)

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        MATMULS["mdct_matmul"] += 1
        return mdct(signal, self.kernel, self.hop_length, self.center)


class IMDCT:
    """Inverse MDCT, the matmul form: spectrum ``(..., F, n_fft//2)`` ->
    waveform: the product with the (N/2, win) matrix ``kernel``, then the
    overlap-add (``overlap_add``: any ``win % hop == 0``, centre-cropped
    with ``center``)."""

    def __init__(self, n_fft: int = 512, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, center: bool = True,
                 device="cpu", dtype=torch.float32):
        self.n_fft = n_fft
        self.win_length = int(win_length or n_fft)
        self.hop_length = int(hop_length or self.win_length // 2)
        self.center = center
        self.kernel = synth_matrix(n_fft, device, dtype, self.win_length)

    def __call__(self, spectrum: torch.Tensor) -> torch.Tensor:
        MATMULS["imdct_matmul"] += 1
        return imdct(spectrum, self.kernel, self.hop_length, self.center)
