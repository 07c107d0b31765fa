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
  against ``spectro_matrix`` (K2: ``[S[:, k:]; S[:, :k]]`` of
  ``synth_matrix``) on the tensor cores in 3xTF32, reading the matrix as
  ``dense_operand`` lays it out, built once per (N, device).  A block
  stages at least 17 hops of the source in shared memory, so it takes N up
  to ``dense_max_n`` (5568 on an H100: 227 KB a block).  Every check of the
  ops refuses a larger N with ``NotImplementedError`` before any launch,
  on every device and for fake tensors, and ``ops/features.py`` gives such
  an N the matmul form from the configuration.

Bound on an H100 SXM at the flagship shape (batch 8, N = 512, 128 frames):
each kernel must move about 2.1 MB (its input, its output and the window),
0.62 us at 3.35 TB/s.  Through the FFT an MDCT frame takes ~6.8 kFLOP,
~7 MFLOP a call, ~0.1 us at the 67 TFLOP/s float32 rate, so both are bound
by bytes.  The dense product is 2*8*128*512*256 = 268 MFLOP; in 3xTF32
that is three TF32 products, 805 MFLOP, 1.6 us at the 495 TFLOP/s TF32
rate: it cannot reach the bound and serves only the other N.

K1 and K2 are PyTorch operators, ``torch.ops.mdctgan.mdct_spectro`` and
``torch.ops.mdctgan.imdct_audio`` (registered when this module is
imported; nothing is built then), so that ``torch.export`` traces them as
nodes of a graph (``export_cli.py``) and a loaded program launches them.
The wrappers ``mdct_spectro`` and ``imdct_audio`` call them: a CPU tensor
runs the plain PyTorch version; a CUDA tensor launches a kernel (adding one
to its count in ``LAUNCHES``) or raises.  Both take hop = win/2 = n_fft/2,
centred, only, as the Pallas kernels did, and raise
``NotImplementedError`` for any other framing a caller names.  The
configurations they cannot serve run the matmul form (``ops/mdct.py``
``MDCT``/``IMDCT``), chosen by ``ops/features.py`` from the configuration
before any launch.
The matrix argument gives N and is the plain version's operand; the FFT
form reads ``fft_tables(N)`` and the dense form ``dense_operand`` of the
float64 matrix instead, each built once per (N, device).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from mdctgan_tpu_torch.ops._build import load_library
# the matrices and tables the kernels read are built by ``ops/mdct.py``
from mdctgan_tpu_torch.ops.mdct import (  # noqa: F401
    fft_tables, imdct, mdct, n_frames, spectro_matrix, synth_matrix)

_LN10 = math.log(10.0)
# The dense form's tile, as csrc/window_gemm.cuh has it: output columns a
# block (dense::BN) and depth values of each half a ring stage (dense::BK);
# and what its shared memory holds: the threads of a block, the W ring's
# stages and floats a stage, the pitch of the warps' sums, and the fewest
# rows a block takes (its BM of 64, 32 or 16).
DENSE_BN, DENSE_BK = 32, 32
DENSE_THREADS, DENSE_STAGES = 256, 5
DENSE_STAGE_FLOATS = 2 * (DENSE_BK // 8) * (DENSE_BN // 8) * 32 * 2
DENSE_RED_PITCH = DENSE_BN + 8
DENSE_MIN_BM = 16
# sm_90's opt-in limit of dynamic shared memory a block (227 KB): the limit
# for a tensor off the card (the plain version; a fake tensor on a host
# without a card)
SM90_SMEM_OPTIN = 232448

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


def dense_smem_bytes(bm: int, hop: int) -> int:
    """``dense::smem_bytes(bm, hop)``: the W ring, then the (bm + 1) staged
    hops of the source (each padded to ``DENSE_BK`` and 4 more floats), or
    the warps' sums where those are larger."""
    hop_pad = -(-hop // DENSE_BK) * DENSE_BK
    span = (bm + 1) * (hop_pad + 4)
    red = DENSE_THREADS // 32 * 16 * DENSE_RED_PITCH
    return 4 * (DENSE_STAGES * DENSE_STAGE_FLOATS + max(span, red))


@functools.lru_cache(maxsize=None)
def _card_smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _smem_optin(device: torch.device) -> int:
    if device.type != "cuda" or not torch.cuda.is_available():
        return SM90_SMEM_OPTIN
    return _card_smem_optin(torch.cuda.current_device() if device.index is None
                            else device.index)


@functools.lru_cache(maxsize=None)
def _dense_max_n(limit: int) -> int:
    hop = 0
    while dense_smem_bytes(DENSE_MIN_BM, hop + DENSE_BK) <= limit:
        hop += DENSE_BK
    # every hop up to this multiple of DENSE_BK pads to at most it, and no
    # larger hop fits: 2 * hop is the largest N
    return 2 * hop


def dense_max_n(device=None) -> int:
    """The largest N the dense form takes on ``device``: ``DENSE_MIN_BM``
    rows' staged source within the card's opt-in shared memory a block
    (``torch.cuda.get_device_properties``), or sm_90's off the card (None,
    the CPU, a fake CUDA tensor on a host without one).  5568 on an H100."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    return _dense_max_n(_smem_optin(dev))


def check_dense_range(name: str, n_fft: int, device) -> None:
    """Raise ``NotImplementedError`` for an N above ``dense_max_n``: every
    such N is the dense form's (``kernel_for``), and its launch would fail."""
    limit = dense_max_n(device)
    if n_fft > limit:
        raise NotImplementedError(
            f"{name}: n_fft {n_fft} is above the dense form's {limit} on {device} "
            "(17 hops of the source must fit in a block's shared memory); the "
            "matmul form (ops/mdct.py) serves it")


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
# the dense form's operand
# --------------------------------------------------------------------------

def dense_halves(kernel: str, n_fft: int) -> np.ndarray:
    """The dense form's matrix in float64 as its two depth halves, (2, N/2,
    N/2): K1's ``spectro_matrix`` rows ``[:N/2]`` and ``[N/2:]``; K2's
    ``S[:, N/2:]`` and ``S[:, :N/2]`` of ``synth_matrix``, the overlap-add
    ``frames[c, hop:] + frames[c+1, :hop]`` folded into the product."""
    k = n_fft // 2
    if kernel == "mdct_spectro":
        return spectro_matrix(n_fft, dtype=torch.float64).numpy().reshape(2, k, k)
    syn = synth_matrix(n_fft, dtype=torch.float64).numpy()
    return np.stack([syn[:, k:], syn[:, :k]])


def dense_operand(halves: np.ndarray) -> np.ndarray:
    """``halves`` (2, hop, width) as the dense kernel reads it, flat float32.

    The depth of each half is zero-padded to ``hop_pad``, a multiple of
    ``DENSE_BK``, and the width to a multiple of ``DENSE_BN``.  Order:
    column tile j, stage s, half h, k8 step, n8 tile, lane ``g * 4 + t``,
    then ``(w(k), w(k + 4))`` with depth ``k = s * DENSE_BK + step * 8 + t``
    and column ``j * DENSE_BN + tile * 8 + g``: a lane's ``(b0, b1)`` of one
    m16n8k8 product as one float2 (``csrc/window_gemm.cuh``, which splits
    each value into its TF32 parts)."""
    _, hop, width = halves.shape
    hp = -(-hop // DENSE_BK) * DENSE_BK
    wp = -(-width // DENSE_BN) * DENSE_BN
    w = np.zeros((2, hp, wp), np.float32)
    w[:, :hop, :width] = halves
    w = w.reshape(2, hp // DENSE_BK, DENSE_BK // 8, 2, 4, wp // DENSE_BN, DENSE_BN // 8, 8)
    # (h, s, step, q, t, j, tile, g) -> (j, s, h, step, tile, g, t, q)
    return np.ascontiguousarray(w.transpose(5, 1, 0, 2, 6, 7, 4, 3)).reshape(-1)


@functools.lru_cache(maxsize=None)
def _dense_operand(kernel: str, n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dense_operand(dense_halves(kernel, n_fft))).to(device)


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


def _check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What the ops take: tensors of one dtype on one device; on the card
    (the kernels) contiguous float32 ones.  The plain version runs in any
    floating dtype on the CPU."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs on {dev} in {dtype} and on {t.device} in {t.dtype}")
        if dev.type != "cpu" and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(
                f"{name}: every input must be a contiguous float32 tensor on "
                f"{dev}; got {t.dtype}" + ("" if t.is_contiguous() else " (not contiguous)")
            )


def _k1_shape(name, signal, mat, hop_length, win_length):
    """K1's inputs checked as each implementation checks them -> (B, T, N, F)."""
    n_fft = mat.shape[0]
    check_geometry(n_fft, hop_length, win_length)
    check_dense_range(name, n_fft, signal.device)
    _check_inputs(name, signal, mat)
    if signal.dim() != 2 or mat.shape != (n_fft, n_fft // 2) or n_fft % 2:
        raise ValueError(
            f"{name}: expected (B, T) and (N, N/2), got "
            f"{tuple(signal.shape)} and {tuple(mat.shape)}"
        )
    b, t = signal.shape
    return b, t, n_fft, n_frames(t, n_fft, n_fft // 2)


def _k2_shape(name, spec, synth, hop_length, win_length):
    """K2's inputs checked as each implementation checks them -> (B, F, K)."""
    k = synth.shape[0]
    check_geometry(2 * k, hop_length, win_length)
    check_dense_range(name, 2 * k, spec.device)
    _check_inputs(name, spec, synth)
    if spec.dim() != 3 or spec.shape[-1] != k or synth.shape != (k, 2 * k):
        raise ValueError(
            f"{name}: expected (B, F, K) and (K, 2K), got "
            f"{tuple(spec.shape)} and {tuple(synth.shape)}"
        )
    b, f, _ = spec.shape
    if f < 2:
        raise ValueError(f"{name}: needs at least 2 frames, got {f}")
    return b, f, k


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


def _on_card(name: str, src: torch.Tensor) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {src.device}")


def _k1(name, signal, mat, gain, scale, shift, hop_length=None, win_length=None):
    n = mat.shape[0]
    b, t, n_fft, f = _k1_shape(name, signal, mat, hop_length or n // 2, win_length or n)
    _on_card(name, signal)
    out = torch.empty((b, f, n_fft // 2), device=signal.device, dtype=torch.float32)
    operand = (_dense_operand("mdct_spectro", n_fft, signal.device) if name.endswith("_dense")
               else _device_tables(n_fft, signal.device))
    return _launch(name, signal, operand, out, b, t, n_fft, f,
                   float(gain), float(scale), float(shift))


def _k2(name, spec, synth, gain, scale, shift, hop_length=None, win_length=None):
    k = synth.shape[0]
    b, f, k = _k2_shape(name, spec, synth, hop_length or k, win_length or 2 * k)
    _on_card(name, spec)
    out = torch.empty((b, (f - 1) * k), device=spec.device, dtype=torch.float32)
    operand = (_dense_operand("imdct_audio", 2 * k, spec.device) if name.endswith("_dense")
               else _device_tables(2 * k, spec.device))
    return _launch(name, spec, operand, out, b, f, 2 * k,
                   float(gain), float(scale), float(shift))


# --------------------------------------------------------------------------
# the registered operators
# --------------------------------------------------------------------------
#
# ``mdctgan::mdct_spectro`` and ``mdctgan::imdct_audio``: the dispatcher
# runs the plain version for CPU tensors, the kernel that ``kernel_for``
# names for CUDA tensors, and the shape function for the fake tensors of
# ``torch.export`` (which have no storage: it touches no pointer and no
# cached table).  All three check the inputs alike, so an export that the
# card would refuse fails when it is made.  No autograd is registered: both
# kernels are forward-only, as in JAX; a backward through them raises.

_K1_SCHEMA = ("(Tensor signal, Tensor mat, float gain, float scale, float shift, "
              "int hop_length, int win_length) -> Tensor")
_K2_SCHEMA = ("(Tensor spec, Tensor synth, float gain, float scale, float shift, "
              "int hop_length, int win_length) -> Tensor")


def _mdct_spectro_cpu(signal, mat, gain, scale, shift, hop_length, win_length):
    _k1_shape("mdct_spectro", signal, mat, hop_length, win_length)
    return mdct_spectro_plain(signal, mat, gain, scale, shift)


def _imdct_audio_cpu(spec, synth, gain, scale, shift, hop_length, win_length):
    _k2_shape("imdct_audio", spec, synth, hop_length, win_length)
    return imdct_audio_plain(spec, synth, gain, scale, shift)


mdct_spectro_op = torch.library.custom_op(
    "mdctgan::mdct_spectro", _mdct_spectro_cpu, mutates_args=(), device_types="cpu",
    schema=_K1_SCHEMA)
imdct_audio_op = torch.library.custom_op(
    "mdctgan::imdct_audio", _imdct_audio_cpu, mutates_args=(), device_types="cpu",
    schema=_K2_SCHEMA)


@mdct_spectro_op.register_kernel("cuda")
def _mdct_spectro_cuda(signal, mat, gain, scale, shift, hop_length, win_length):
    return _k1(kernel_for("mdct_spectro", mat.shape[0]), signal, mat, gain, scale, shift,
               hop_length, win_length)


@imdct_audio_op.register_kernel("cuda")
def _imdct_audio_cuda(spec, synth, gain, scale, shift, hop_length, win_length):
    return _k2(kernel_for("imdct_audio", 2 * synth.shape[0]), spec, synth, gain, scale, shift,
               hop_length, win_length)


@mdct_spectro_op.register_fake
def _mdct_spectro_fake(signal, mat, gain, scale, shift, hop_length, win_length):
    b, _, n_fft, f = _k1_shape("mdct_spectro", signal, mat, hop_length, win_length)
    return signal.new_empty((b, f, n_fft // 2))


@imdct_audio_op.register_fake
def _imdct_audio_fake(spec, synth, gain, scale, shift, hop_length, win_length):
    b, f, k = _k2_shape("imdct_audio", spec, synth, hop_length, win_length)
    return spec.new_empty((b, (f - 1) * k))


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only (no gradient, as in JAX): "
                           "call it under torch.no_grad() or on a detached input")


def mdct_spectro(signal, mat, gain=0.0, scale=1.0, shift=0.0,
                 hop_length=None, win_length=None):
    """K1: (B, T) float32 -> (B, F, N/2); ``mat`` from ``spectro_matrix``.
    Calls ``mdctgan::mdct_spectro``: on CUDA the form ``kernel_for`` names.
    A caller's framing (``hop_length``, ``win_length``; default N/2 and N)
    other than hop = win/2 = N raises ``NotImplementedError`` on any
    device; an input that requires grad raises with grad enabled."""
    n_fft = mat.shape[0]
    _forward_only("mdct_spectro", signal, mat)
    return mdct_spectro_op(signal, mat, float(gain), float(scale), float(shift),
                           hop_length or n_fft // 2, win_length or n_fft)


def mdct_spectro_dense(signal, mat, gain=0.0, scale=1.0, shift=0.0):
    """K1's dense form at any even N (``mat`` gives N; the kernel reads
    ``dense_operand`` of the float64 matrix), launched directly, not through
    the registered op."""
    if signal.device.type == "cpu":
        return mdct_spectro_plain(signal, mat, gain, scale, shift)
    return _k1("mdct_spectro_dense", signal, mat, gain, scale, shift)


def imdct_audio(spec, synth, gain=0.0, scale=1.0, shift=0.0,
                hop_length=None, win_length=None):
    """K2: (B, F, N/2) float32 -> (B, (F-1)*N/2); ``synth`` from
    ``synth_matrix``.  Calls ``mdctgan::imdct_audio``: on CUDA the form
    ``kernel_for`` names.  A framing other than hop = win/2 = N raises, as
    ``mdct_spectro``'s."""
    n_fft = 2 * synth.shape[0]
    _forward_only("imdct_audio", spec, synth)
    return imdct_audio_op(spec, synth, float(gain), float(scale), float(shift),
                          hop_length or n_fft // 2, win_length or n_fft)


def imdct_audio_dense(spec, synth, gain=0.0, scale=1.0, shift=0.0):
    """K2's dense form at any even N (``synth`` gives N; the kernel reads
    ``dense_operand`` of the float64 matrix), launched directly, not through
    the registered op."""
    if spec.device.type == "cpu":
        return imdct_audio_plain(spec, synth, gain, scale, shift)
    return _k2("imdct_audio_dense", spec, synth, gain, scale, shift)
