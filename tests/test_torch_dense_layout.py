"""The dense form of K1/K2 (``csrc/window_gemm.cuh``) read on the CPU.

The kernel runs only on the card; these tests hold what it is given and how
it reads it.  ``_emulate`` walks the kernel's grid, warps and lanes with the
index arithmetic of ``window_gemm_kernel``: it stages the source span, reads
A fragments from it and B fragments from ``dense_operand`` as the kernel
does, multiplies them with the m16n8k8 fragment layout of the PTX ISA, sums
the two depth halves and applies the epilogue.  Its output is held against
the plain versions.  The kernel itself is held on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mdctgan_tpu_torch.ops import mdct_kernels as K

HEADER = Path(K.__file__).resolve().parent.parent / "csrc" / "window_gemm.cuh"
GAIN = 1000.0


def _tf32(x):
    """float32 ``x`` rounded to TF32 as the kernel rounds it (to nearest,
    ties away from zero; the low 13 bits zero)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _header_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text()).group(1))


def test_python_tile_matches_the_header():
    assert (K.DENSE_BN, K.DENSE_BK) == (_header_int("BN"), _header_int("BK"))
    assert _header_int("THREADS") == 256 and _header_int("STAGES") >= 2


def _mma(a, b):
    """One m16n8k8 product of a warp: ``a`` (32, 4), ``b`` (32, 2) per lane
    -> the lanes' (32, 4) accumulators, in the PTX ISA's fragment layout."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a.T
    B[t, g], B[t + 4, g] = b.T
    D = A @ B
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]], 1)


def _emulate(src, src_len, rows, hop, width, offset, wop, bm, pro, epi, passes=3):
    """``window_gemm_kernel<bm, passes>`` over every block, in float64."""
    bn, bk = K.DENSE_BN, K.DENSE_BK
    kk_n, ntiles = bk // 8, bn // 8
    wf = 2
    stage_floats = 2 * kk_n * ntiles * 32 * wf
    warps_m = bm // 16
    ksplit = 4 // warps_m
    hp = -(-hop // bk) * bk
    p = hp + 4
    n_stages = hp // bk
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    batch = src.shape[0]
    out = np.full((batch, rows, width), np.nan)
    for z in range(batch):
        sb = src[z]
        for x in range(-(-rows // bm)):
            r0 = x * bm
            j0 = r0 * hop - offset
            span = np.zeros((bm + 1) * p)
            for c in range(bm + 1):
                for e in range(hop):
                    gi = j0 + c * hop + e
                    if 0 <= gi < src_len:
                        span[c * p + e] = pro(sb[gi])
            for y in range(-(-width // bn)):
                wt = wop[y * n_stages * stage_floats:(y + 1) * n_stages * stage_floats]
                red = np.zeros((8, 16, bn))
                for warp in range(8):
                    h, wm, ks = warp >> 2, (warp & 3) % warps_m, (warp & 3) // warps_m
                    acc = np.zeros((ntiles, 32, 4))
                    for s in range(n_stages):
                        slot = wt[s * stage_floats:(s + 1) * stage_floats].reshape(-1, wf)
                        for kk in range(ks, kk_n, ksplit):
                            base = (wm * 16 + g + h) * p + t + s * bk + kk * 8
                            a = np.stack([span[base], span[base + 8 * p], span[base + 4],
                                          span[base + 8 * p + 4]], 1)
                            a_hi = _tf32(a.astype(np.float32)).astype(np.float64)
                            for jn in range(ntiles):
                                w = slot[((h * kk_n + kk) * ntiles + jn) * 32 + lane]
                                if passes == 3:
                                    acc[jn] += _mma(a, w.astype(np.float64))
                                else:
                                    acc[jn] += _mma(a_hi, _tf32(w).astype(np.float64))
                    for jn in range(ntiles):
                        n = jn * 8 + 2 * t
                        red[warp, g, n], red[warp, g, n + 1] = acc[jn, :, 0], acc[jn, :, 1]
                        red[warp, g + 8, n], red[warp, g + 8, n + 1] = acc[jn, :, 2], acc[jn, :, 3]
                for m in range(bm):
                    for c in range(bn):
                        r, n = r0 + m, y * bn + c
                        if r < rows and n < width:
                            total = sum(red[(hk // ksplit) * 4 + (hk % ksplit) * warps_m + m // 16,
                                            m % 16, c] for hk in range(2 * ksplit))
                            out[z, r, n] = epi(total)
    return out


def _k1_case(rng, n_fft, t):
    x = np.sqrt(512 / n_fft) * rng.standard_normal((2, t))
    return x, K.mdct_spectro_plain(torch.from_numpy(x), K.spectro_matrix(
        n_fft, dtype=torch.float64), GAIN, 0.2, 0.0).numpy()


def _compress(y):
    return K.compress(torch.tensor(y), GAIN, 0.2, 0.0).item()


def _expand(y):
    return K.expand(torch.tensor(y), GAIN, 5.0, 0.0).item()


@pytest.mark.parametrize("n_fft,t,bm", [(200, 1900, 16), (96, 1500, 32), (480, 4560, 64)])
def test_dense_k1_as_the_kernel_reads_it(rng, n_fft, t, bm):
    """K1's dense form, emulated at each row tile (16, 32, 64) and at an N
    whose N/2 is not a multiple of 8 (200): within 2e-4 of the float64 plain
    version, inside K1's 5e-4.  The emulation keeps A in float64 and W in
    float32, which the arcsinh's slope of ~87 at 0 reads as up to ~5e-5
    here.  A misplaced index moves outputs by ~1."""
    hop = n_fft // 2
    x, ref = _k1_case(rng, n_fft, t)
    f = K.n_frames(t, n_fft, hop)
    got = _emulate(x, t, f, hop, hop, hop, K.dense_operand(K.dense_halves("mdct_spectro", n_fft)),
                   bm, lambda v: v, _compress)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("n_fft,frames,bm", [(200, 21, 16), (480, 12, 32), (96, 40, 64)])
def test_dense_k2_as_the_kernel_reads_it(rng, n_fft, frames, bm):
    """K2's dense form emulated: the spectrum denormalised once as it is
    staged, the overlap-add folded into the operand; within 1e-6 of the
    float64 plain version."""
    k = n_fft // 2
    y = rng.uniform(-1, 1, (2, frames, k))
    ref = K.imdct_audio_plain(torch.from_numpy(y), K.synth_matrix(n_fft, dtype=torch.float64),
                              GAIN, 5.0, 0.0).numpy()
    got = _emulate(y.reshape(2, -1), frames * k, frames - 1, k, k, 0,
                   K.dense_operand(K.dense_halves("imdct_audio", n_fft)), bm, _expand,
                   lambda v: v).reshape(2, -1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_dense_control_tf32x1_is_visible(rng):
    """The 1xTF32 control (hi x hi only, on no path) is far outside K1's 5e-4
    bound at the arcsinh's steep slope, which is why the product is split."""
    n_fft, t = 96, 1500
    x, ref = _k1_case(rng, n_fft, t)
    got = _emulate(x, t, K.n_frames(t, n_fft, 48), 48, 48, 48,
                   K.dense_operand(K.dense_halves("mdct_spectro", n_fft)), 32,
                   lambda v: v, _compress, passes=1)
    assert np.abs(got - ref).max() > 5e-4


def test_dense_operand_order_and_padding():
    """The operand holds the float32 matrix, each value once, in the
    fragment order; the padding rows and columns are zero; one slot of
    2 * BK * BN floats per (column tile, stage)."""
    for kernel in ("mdct_spectro", "imdct_audio"):
        for n_fft in (200, 960):
            halves = K.dense_halves(kernel, n_fft)
            op = K.dense_operand(halves)
            hop = n_fft // 2
            hp, wp = -(-hop // K.DENSE_BK) * K.DENSE_BK, -(-hop // K.DENSE_BN) * K.DENSE_BN
            assert op.dtype == np.float32 and op.size == 2 * hp * wp
            pair = op.reshape(wp // K.DENSE_BN, hp // K.DENSE_BK, 2, K.DENSE_BK // 8,
                              K.DENSE_BN // 8, 8, 4, 2)
            # back to (h, depth, column): depth = s*BK + step*8 + q*4 + t
            w = pair.transpose(2, 1, 3, 7, 6, 0, 4, 5).reshape(2, hp, wp)
            np.testing.assert_array_equal(w[:, :hop, :hop], halves.astype(np.float32))
            assert not w[:, hop:].any() and not w[:, :, hop:].any()


def test_dense_halves_fold_the_overlap_add(rng):
    """The halves times [x[c], x[c+1]] are the plain K2's chunk c, and the
    halves of K1 are the matrix's two halves of rows."""
    n_fft = 200
    k = n_fft // 2
    syn = K.synth_matrix(n_fft, dtype=torch.float64)
    spec = torch.from_numpy(rng.standard_normal((1, 5, k)))
    halves = torch.from_numpy(K.dense_halves("imdct_audio", n_fft))
    rows = torch.cat([spec[0, :-1], spec[0, 1:]], 1)
    np.testing.assert_allclose((rows @ torch.cat([halves[0], halves[1]])).reshape(-1).numpy(),
                               K.imdct_audio_plain(spec, syn)[0].numpy(), atol=1e-12)
    mat = K.spectro_matrix(n_fft, dtype=torch.float64).numpy()
    np.testing.assert_array_equal(K.dense_halves("mdct_spectro", n_fft).reshape(n_fft, k), mat)
