// Sliding-window matrix product: the dense form of the MDCT (K1) and IMDCT
// (K2) kernels, for the N that the FFT form (mdct_fft.cuh) does not take,
// i.e. any even N that is not a power of two in [64, 2048].  For those N it
// replaces mdctgan_tpu/ops/pallas_mdct.py:80 (mdct_spectro_fused) and
// pallas_mdct.py:185 (imdct_audio_fused).
//
//   out[b, r, n] = epi( sum_{d < depth} pro(src[b, r*row_stride + d - offset]) * W(d, n) )
//
// Row r of the left operand is a window of the source that starts
// row_stride samples after row r-1's.  Both transforms have this form with
// row_stride = depth / 2:
//   * K1 (MDCT): a frame is N consecutive samples of the centre-padded
//     signal, hop N/2.  The padding is never materialised: a source index
//     outside [0, src_len) reads as zero.
//   * K2 (IMDCT + overlap-add): output chunk c is frames[c, hop:] +
//     frames[c+1, :hop], i.e. the row [x[c], x[c+1]] (2K consecutive spectrum
//     values) times [S[:, hop:]; S[:, :hop]].  No atomics: each output sample
//     is one dot product that already sums its two half-frames.
//
// The product is plain float32 FMAs (no TF32, no bf16): the transforms feed
// an arcsinh of gain 1000 and a sinh whose slope reaches ~575x, so they keep
// full float32.  Each block computes a BM x BN output tile, staging a BM x BK
// slice of source windows and a BK x BN slice of the matrix in shared memory
// per step; each thread accumulates a TM x TN register tile.
//
// Bound on an H100 SXM: the function is bound by bytes (about 8 bytes a
// spectrum value, at 3.35 TB/s; 0.46 us at N = 480, batch 8, T = 24000),
// but this form does the dense (N, N/2) product, N*N/2 FMAs a frame (2.8 us
// at that shape at the 67 TFLOP/s float32 rate): far more operations than
// an FFT needs.  It is kept only for the geometries the FFT form does not
// cover.  It reads the overlapping windows straight from the source, so no
// padded signal or frame tensor is written.

#pragma once

#include <cuda_runtime.h>

namespace mdctgan {

constexpr int BM = 32;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 16;  // depth per shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128

// W(d, n) = w[d * width + n]: a row-major (depth, width) matrix.
struct RowMajorW {
  const float* w;
  int width;
  __device__ __forceinline__ float operator()(int d, int n) const {
    return __ldg(w + static_cast<long long>(d) * width + n);
  }
};

template <class Pro, class WLoad, class Epi>
__global__ void __launch_bounds__(THREADS)
window_gemm_kernel(const float* __restrict__ src, long long src_len,
                   int rows, int depth, int width, int row_stride, int offset,
                   WLoad wload, float* __restrict__ out, Pro pro, Epi epi) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float* sb = src + static_cast<long long>(blockIdx.z) * src_len;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += BK) {
    // Source windows: neighbouring threads read neighbouring samples.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int d = e % BK;
      const int r = e / BK;
      const int gr = r0 + r;
      const int gd = k0 + d;
      float v = 0.f;
      if (gr < rows && gd < depth) {
        const long long idx =
            static_cast<long long>(gr) * row_stride + gd - offset;
        if (idx >= 0 && idx < src_len) v = pro(__ldg(sb + idx));
      }
      As[d][r] = v;
    }
    // Matrix slice: neighbouring threads read neighbouring columns.
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int n = e % BN;
      const int d = e / BN;
      const int gn = n0 + n;
      const int gd = k0 + d;
      Bs[d][n] = (gn < width && gd < depth) ? wload(gd, gn) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int d = 0; d < BK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&As[d][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[d][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = out + static_cast<long long>(blockIdx.z) * rows * width;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty * TM + i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < width) ob[static_cast<long long>(gr) * width + gn] = epi(acc[i][j]);
    }
  }
}

inline dim3 window_gemm_grid(int rows, int width, int batch) {
  return dim3((rows + BM - 1) / BM, (width + BN - 1) / BN, batch);
}

}  // namespace mdctgan
