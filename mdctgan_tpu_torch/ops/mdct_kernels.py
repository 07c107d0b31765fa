"""The serving chain's two transform kernels, each beside its plain version.

K1 ``mdct_spectro``  replaces ``mdctgan_tpu/ops/pallas_mdct.py:mdct_spectro_fused``
    (B, T) waveform -> (B, F, N/2) centre-padded MDCT, then
    ``asinh(gain*x)/ln10`` (gain != 0) and ``*scale + shift``.
    CUDA: ``csrc/mdct_spectro.cu``.
K2 ``imdct_audio``   replaces ``mdctgan_tpu/ops/pallas_mdct.py:imdct_audio_fused``
    (B, F, N/2) normalised spectrum -> ``*scale + shift``, then
    ``sinh(x*ln10)/gain`` (gain != 0), the synthesis product and the
    centre-cropped overlap-add -> (B, (F-1)*N/2) waveform.
    CUDA: ``csrc/imdct_audio.cu``.

Each has two CUDA forms, chosen by N alone (``kernel_for``), never by
failure:

* the FFT form (``csrc/mdct_fft.cuh``) for power-of-two N in [64, 2048]: a
  DCT-IV through an N/4-point complex FFT, one group of lanes per frame,
  with the window and twiddles of ``fft_tables``;
* the dense form (``csrc/window_gemm.cuh``; ``mdct_spectro_dense``,
  ``imdct_audio_dense``) for every other even N: the (N, N/2) product
  against ``spectro_matrix``/``synth_matrix``.

Bound on an H100 SXM at the flagship shape (batch 8, N = 512, 128 frames):
each kernel must move about 2.1 MB (its input, its output and the window),
0.62 us at 3.35 TB/s.  Through the FFT an MDCT frame takes ~6.8 kFLOP,
~7 MFLOP a call, ~0.1 us at the 67 TFLOP/s float32 rate, so both are bound
by bytes.  The dense product is 2*8*128*512*256 = 268 MFLOP, ~4.0 us at
that rate: it cannot reach the bound and serves only the other N.

A wrapper given a CPU tensor runs the plain PyTorch version; given a CUDA
tensor it launches a kernel (adding one to its count in ``LAUNCHES``) or
raises.  Both take hop = win/2 = n_fft/2, centred, only, as the Pallas
kernels did: ``mdct_spectro`` and ``imdct_audio`` raise
``NotImplementedError`` for any other framing a caller names.  The
configurations they cannot serve run the matmul form (``ops/mdct.py``
``MDCT``/``IMDCT``), chosen by ``ops/features.py`` from the configuration
before any launch.
The matrix argument gives N and is the plain version's operand; the FFT
form reads ``fft_tables(N)`` instead, built once per device.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mdctgan_tpu_torch.ops._build import load_library
# the matrices and tables the kernels read are built by ``ops/mdct.py``
from mdctgan_tpu_torch.ops.mdct import (  # noqa: F401
    fft_tables, imdct, mdct, n_frames, spectro_matrix, synth_matrix)

_LN10 = math.log(10.0)

# Kernel launches since the last ``reset_launch_counts()``; only the wrappers
# below add to these, and only where they launch.
LAUNCHES = {"mdct_spectro": 0, "imdct_audio": 0,
            "mdct_spectro_dense": 0, "imdct_audio_dense": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check_geometry(n_fft: int, hop_length: int, win_length: int) -> None:
    if win_length != n_fft or hop_length * 2 != win_length:
        raise NotImplementedError("fused kernels require hop = win/2 = n_fft/2")


def kernel_for(kernel: str, n_fft: int) -> str:
    """The ``LAUNCHES`` key that ``kernel`` (``"mdct_spectro"`` or
    ``"imdct_audio"``) launches on a CUDA tensor of this N: its FFT form
    for a power of two in [64, 2048], its dense form otherwise."""
    fft = 64 <= n_fft <= 2048 and n_fft & (n_fft - 1) == 0
    return kernel if fft else f"{kernel}_dense"


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def compress(spec, gain=0.0, scale=1.0, shift=0.0):
    """K1's epilogue: ``asinh(gain*x)/ln10`` (gain != 0), then ``*scale + shift``."""
    if gain != 0.0:
        spec = torch.asinh(gain * spec) / _LN10
    return spec * scale + shift


def expand(x, gain=0.0, scale=1.0, shift=0.0):
    """K2's prologue: ``*scale + shift``, then ``sinh(x*ln10)/gain``
    (gain != 0); with the inverse affine it undoes ``compress``."""
    x = x * scale + shift
    if gain != 0.0:
        x = torch.sinh(x * _LN10) / gain
    return x


def mdct_spectro_plain(signal, mat, gain=0.0, scale=1.0, shift=0.0):
    """K1 in plain PyTorch, in the dtype of ``signal`` and ``mat``."""
    return compress(mdct(signal, mat), gain, scale, shift)


def imdct_audio_plain(spec, synth, gain=0.0, scale=1.0, shift=0.0):
    """K2 in plain PyTorch, in the dtype of ``spec`` and ``synth``."""
    return imdct(expand(spec, gain, scale, shift), synth)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C signatures of csrc/<kernel>.cu, shared by its FFT and dense entries
_ARGTYPES = {
    "mdct_spectro": [_P, _P, _P, _I, ctypes.c_longlong, _I, _I, _F, _F, _F, _P],
    "imdct_audio": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
}


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    """The C entry ``<name>_launch`` of the library built from
    ``csrc/<kernel>.cu``; ``name`` may carry a ``_dense`` suffix."""
    kernel = name.removesuffix("_dense")
    fn = getattr(load_library(kernel), f"{name}_launch")
    fn.argtypes = _ARGTYPES[kernel]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _device_tables(n_fft: int, device: torch.device) -> torch.Tensor:
    return fft_tables(n_fft, device)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: every input must be a contiguous float32 tensor on "
                f"{dev}; got {t.dtype} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)")
            )


def _launch(name: str, src: torch.Tensor, operand: torch.Tensor,
            out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(name)(src.data_ptr(), operand.data_ptr(),
                              out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _k1(name, signal, mat, gain, scale, shift):
    _check_cuda(name, signal, mat)
    n_fft = mat.shape[0]
    if signal.dim() != 2 or mat.shape != (n_fft, n_fft // 2) or n_fft % 2:
        raise ValueError(
            f"{name}: expected (B, T) and (N, N/2), got "
            f"{tuple(signal.shape)} and {tuple(mat.shape)}"
        )
    b, t = signal.shape
    f = n_frames(t, n_fft, n_fft // 2)
    out = torch.empty((b, f, n_fft // 2), device=signal.device, dtype=torch.float32)
    operand = mat if name.endswith("_dense") else _device_tables(n_fft, signal.device)
    return _launch(name, signal, operand, out, b, t, n_fft, f,
                   float(gain), float(scale), float(shift))


def _k2(name, spec, synth, gain, scale, shift):
    _check_cuda(name, spec, synth)
    k = synth.shape[0]
    if spec.dim() != 3 or spec.shape[-1] != k or synth.shape != (k, 2 * k):
        raise ValueError(
            f"{name}: expected (B, F, K) and (K, 2K), got "
            f"{tuple(spec.shape)} and {tuple(synth.shape)}"
        )
    b, f, _ = spec.shape
    if f < 2:
        raise ValueError(f"{name}: needs at least 2 frames, got {f}")
    out = torch.empty((b, (f - 1) * k), device=spec.device, dtype=torch.float32)
    operand = synth if name.endswith("_dense") else _device_tables(2 * k, spec.device)
    return _launch(name, spec, operand, out, b, f, 2 * k,
                   float(gain), float(scale), float(shift))


def mdct_spectro(signal, mat, gain=0.0, scale=1.0, shift=0.0,
                 hop_length=None, win_length=None):
    """K1: (B, T) float32 -> (B, F, N/2); ``mat`` from ``spectro_matrix``.
    On CUDA: the form ``kernel_for`` names.  A caller's framing
    (``hop_length``, ``win_length``; default N/2 and N) other than hop =
    win/2 = N raises ``NotImplementedError`` on any device."""
    n_fft = mat.shape[0]
    check_geometry(n_fft, hop_length or n_fft // 2, win_length or n_fft)
    if signal.device.type == "cpu":
        return mdct_spectro_plain(signal, mat, gain, scale, shift)
    return _k1(kernel_for("mdct_spectro", n_fft), signal, mat, gain, scale, shift)


def mdct_spectro_dense(signal, mat, gain=0.0, scale=1.0, shift=0.0):
    """K1's dense form at any even N (the product with ``mat``)."""
    if signal.device.type == "cpu":
        return mdct_spectro_plain(signal, mat, gain, scale, shift)
    return _k1("mdct_spectro_dense", signal, mat, gain, scale, shift)


def imdct_audio(spec, synth, gain=0.0, scale=1.0, shift=0.0,
                hop_length=None, win_length=None):
    """K2: (B, F, N/2) float32 -> (B, (F-1)*N/2); ``synth`` from
    ``synth_matrix``.  On CUDA: the form ``kernel_for`` names.  A framing
    other than hop = win/2 = N raises, as ``mdct_spectro``'s."""
    n_fft = 2 * synth.shape[0]
    check_geometry(n_fft, hop_length or n_fft // 2, win_length or n_fft)
    if spec.device.type == "cpu":
        return imdct_audio_plain(spec, synth, gain, scale, shift)
    return _k2(kernel_for("imdct_audio", n_fft), spec, synth, gain, scale, shift)


def imdct_audio_dense(spec, synth, gain=0.0, scale=1.0, shift=0.0):
    """K2's dense form at any even N (the product with ``synth``)."""
    if spec.device.type == "cpu":
        return imdct_audio_plain(spec, synth, gain, scale, shift)
    return _k2("imdct_audio_dense", spec, synth, gain, scale, shift)
