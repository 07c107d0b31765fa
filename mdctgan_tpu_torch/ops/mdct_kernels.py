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

Bound on an H100 SXM at the flagship shape (batch 8, N = 512, F = 128): each
kernel must move about 2.6 MB, ~0.8 us at 3.35 TB/s.  The transform needs far
fewer operations than that: through an N/4-point complex FFT an MDCT frame
takes ~6.8 kFLOP, ~7 MFLOP per call, ~0.1 us at the 67 TFLOP/s float32 rate.
So both are bound by bytes.  The dense (N, N/2) product these kernels do
instead is 2*8*128*512*256 = 268 MFLOP, ~4.0 us at that rate.  Their design (``csrc/window_gemm.cuh``) reads the
overlapping windows straight from the source, so neither the padded signal,
the frames nor the synthesis frames are written to device memory.

A wrapper given a CPU tensor runs the plain PyTorch version; given a CUDA
tensor it launches the kernel (adding one to ``LAUNCHES``) or raises.  Both
take hop = win/2 = n_fft/2 only, as the Pallas kernels did.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mdctgan_tpu_torch.ops._build import load_library
# the matrices the wrappers take are built by ``ops/mdct.py``; re-exported
from mdctgan_tpu_torch.ops.mdct import imdct, mdct, spectro_matrix, synth_matrix  # noqa: F401

_LN10 = math.log(10.0)

# Kernel launches since the last ``reset_launch_counts()``; only the wrappers
# below add to these, and only where they launch.
LAUNCHES = {"mdct_spectro": 0, "imdct_audio": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check_geometry(n_fft: int, hop_length: int, win_length: int) -> None:
    if win_length != n_fft or hop_length * 2 != win_length:
        raise NotImplementedError("fused kernels require hop = win/2 = n_fft/2")


def n_frames_of(t: int, hop_length: int) -> int:
    """Frames of a centre-padded signal of ``t`` samples (hop = win/2)."""
    total = t + 2 * hop_length + (-t) % hop_length
    return total // hop_length - 1


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

@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "mdct_spectro":
        fn = lib.mdct_spectro_launch
        fn.argtypes = [p, p, p, i, ctypes.c_longlong, i, i, f, f, f, p]
    else:
        fn = lib.imdct_audio_launch
        fn.argtypes = [p, p, p, i, i, i, f, f, f, p]
    fn.restype = ctypes.c_int
    return lib


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


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def mdct_spectro(signal, mat, gain=0.0, scale=1.0, shift=0.0):
    """K1: (B, T) float32 -> (B, F, N/2); ``mat`` from ``spectro_matrix``."""
    if signal.device.type == "cpu":
        return mdct_spectro_plain(signal, mat, gain, scale, shift)
    _check_cuda("mdct_spectro", signal, mat)
    n_fft = mat.shape[0]
    if signal.dim() != 2 or mat.shape != (n_fft, n_fft // 2) or n_fft % 2:
        raise ValueError(
            f"mdct_spectro: expected (B, T) and (N, N/2), got "
            f"{tuple(signal.shape)} and {tuple(mat.shape)}"
        )
    b, t = signal.shape
    f = n_frames_of(t, n_fft // 2)
    out = torch.empty((b, f, n_fft // 2), device=signal.device, dtype=torch.float32)
    with torch.cuda.device(signal.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("mdct_spectro").mdct_spectro_launch(
            signal.data_ptr(), mat.data_ptr(), out.data_ptr(), b, t, n_fft, f,
            float(gain), float(scale), float(shift), stream,
        )
    _raise_on("mdct_spectro", err)
    LAUNCHES["mdct_spectro"] += 1
    return out


def imdct_audio(spec, synth, gain=0.0, scale=1.0, shift=0.0):
    """K2: (B, F, N/2) float32 -> (B, (F-1)*N/2); ``synth`` from
    ``synth_matrix``."""
    if spec.device.type == "cpu":
        return imdct_audio_plain(spec, synth, gain, scale, shift)
    _check_cuda("imdct_audio", spec, synth)
    k = synth.shape[0]
    if spec.dim() != 3 or spec.shape[-1] != k or synth.shape != (k, 2 * k):
        raise ValueError(
            f"imdct_audio: expected (B, F, K) and (K, 2K), got "
            f"{tuple(spec.shape)} and {tuple(synth.shape)}"
        )
    b, f, _ = spec.shape
    if f < 2:
        raise ValueError(f"imdct_audio: needs at least 2 frames, got {f}")
    out = torch.empty((b, (f - 1) * k), device=spec.device, dtype=torch.float32)
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("imdct_audio").imdct_audio_launch(
            spec.data_ptr(), synth.data_ptr(), out.data_ptr(), b, f, 2 * k,
            float(gain), float(scale), float(shift), stream,
        )
    _raise_on("imdct_audio", err)
    LAUNCHES["imdct_audio"] += 1
    return out
