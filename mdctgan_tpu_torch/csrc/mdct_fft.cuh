// The MDCT kernels' transform through a Q-point complex FFT, Q = N/4.
//
// Shared by K1 (mdct_spectro.cu, replacing pallas_mdct.py:80
// mdct_spectro_fused) and K2 (imdct_audio.cu, replacing pallas_mdct.py:185
// imdct_audio_fused) for every power-of-two N in [64, 2048].  With M = N/2
// both reduce to a DCT-IV of M points:
//
//   z[m] = (v[2m] + i v[M-1-2m]) * pre[m]         m < Q
//   Z    = FFT_Q(z)
//   W[m] = Z[m] * post[m]
//   X[2m] = Re W[m],  X[M-1-2m] = -Im W[m]
//
// K1 feeds it the windowed frame folded to M values; K2 feeds it the
// spectrum and unfolds the result.  The window and every twiddle come from
// one table built on the host in float64 (ops/mdct.py fft_tables), laid out
// as [window: N][pre: Q][roots: Q/2][post: Q][post_inv: Q] with complex
// values as (re, im) pairs; no sincosf runs here.
//
// Bound on an H100 SXM: at the flagship shape (batch 8, N = 512, 128 frames)
// either kernel must move ~2.1 MB (signal or spectrum in, the other out, the
// window), 0.62 us at 3.35 TB/s.  The FFT needs ~6.8 kFLOP a frame, ~7 MFLOP
// a call, 0.1 us at the 67 TFLOP/s float32 rate: bound by bytes.  So the
// design reads each input once and writes each output once, coalesced, and
// keeps every intermediate in shared memory and registers.  A group of
// G = min(32, Q/2) lanes owns one frame; its FFT is a radix-2 decimation in
// frequency held in the group's registers, trading values by warp shuffle,
// so the groups of a block never wait for one another inside the
// transform.  Each block runs 128 threads, i.e. 128/G frames.  Full
// float32 throughout (no TF32, no bf16): the transforms feed asinh(1000 x)
// and a sinh whose slope reaches ~575x.
//
// Measured (chip_smoke.py, H100 SXM at 700 W): ~4 us of device time at the
// flagship shape, ~12% of the bound, of which ~1 us is an empty kernel of
// the same grid.  The rest is latency: ~8 warps an SM, each one frame's
// chain of loads, transform and stores.  wgmma, TMA and persistent blocks
// do not shorten that chain; fusing the kernel into its neighbours would.

#pragma once

#include <cuda_runtime.h>

namespace mdctgan {

constexpr float kLn10 = 2.302585092994045684f;
constexpr int kFftThreads = 128;  // threads of every FFT block

struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

// Lanes per frame and frames per block for a Q-point FFT.
template <int Q>
struct FftShape {
  static_assert(Q >= 16 && Q <= 512 && (Q & (Q - 1)) == 0,
                "Q must be a power of two in [16, 512]");
  static constexpr int M = 2 * Q;
  static constexpr int N = 4 * Q;
  static constexpr int G = Q / 2 < 32 ? Q / 2 : 32;
  static constexpr int FRAMES = kFftThreads / G;
  static constexpr int PER = Q / G;  // complex values per lane
  static constexpr int LOG2Q = Q == 16    ? 4
                               : Q == 32  ? 5
                               : Q == 64  ? 6
                               : Q == 128 ? 7
                               : Q == 256 ? 8
                                          : 9;
};

// The sections of the flat table of fft_tables(N).
template <int Q>
struct FftTables {
  const float* window;
  const float2* pre;
  const float2* roots;
  const float2* post;
  const float2* post_inv;
  __host__ __device__ explicit FftTables(const float* t)
      : window(t),
        pre(reinterpret_cast<const float2*>(t + 4 * Q)),
        roots(reinterpret_cast<const float2*>(t + 6 * Q)),
        post(reinterpret_cast<const float2*>(t + 7 * Q)),
        post_inv(reinterpret_cast<const float2*>(t + 9 * Q)) {}
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// DCT-IV of M = 2Q points by one group of G lanes.  v(j) gives input j < M
// and may read x; on return x (Q complex = M floats of shared memory), read
// as floats, holds epi(X[k]) for k < M.  Every lane of the warp must call
// it (the groups of one warp share its shuffles and its __syncwarp).
//
// The FFT stays in registers: lane l holds points l + G*i, i < Q/G.  It is
// a radix-2 decimation in frequency; a stage whose pairs lie half >= G
// points apart joins values within a lane, a closer one trades them with
// lane l ^ half by shuffle.  Its output lies at bit-reversed positions,
// which the unpack reads as such.
template <int Q, class In, class Epi>
__device__ __forceinline__ void dct4(float2* x, const float2* __restrict__ pre,
                                     const float2* __restrict__ roots,
                                     const float2* __restrict__ post,
                                     int lane, In v, Epi epi) {
  using S = FftShape<Q>;
  constexpr int M = S::M;
  constexpr int G = S::G;
  float2 z[S::PER];
  // pre-twiddle: z[m] = (v[2m] + i v[M-1-2m]) pre[m]
#pragma unroll
  for (int i = 0; i < S::PER; ++i) {
    const int m = lane + i * G;
    z[i] = cmul(make_float2(v(2 * m), v(M - 1 - 2 * m)), __ldg(pre + m));
  }
  // stage `len` splits blocks of len points: top' = a + b and
  // bottom' = (a - b) roots[(p mod half) * Q/len] for the pair (p, p + half)
#pragma unroll
  for (int len = Q, shift = 0; len >= 2; len >>= 1, ++shift) {
    const int half = len >> 1;
    if (half >= G) {
      const int hh = half / G;
#pragma unroll
      for (int i = 0; i < S::PER; ++i) {
        if ((i & (2 * hh - 1)) < hh) {
          const float2 a = z[i], b = z[i + hh];
          const int k = lane + G * (i & (hh - 1));
          z[i] = cadd(a, b);
          z[i + hh] = cmul(csub(a, b), __ldg(roots + (k << shift)));
        }
      }
    } else {
      const bool top = (lane & half) == 0;
      const float2 w = __ldg(roots + ((lane & (half - 1)) << shift));
#pragma unroll
      for (int i = 0; i < S::PER; ++i) {
        const float2 o = make_float2(__shfl_xor_sync(0xffffffffu, z[i].x, half),
                                     __shfl_xor_sync(0xffffffffu, z[i].y, half));
        z[i] = top ? cadd(z[i], o) : cmul(csub(o, z[i]), w);
      }
    }
  }
  // post-twiddle and unpack: point p holds Z[brev(p)]
  __syncwarp();  // every read that v made of x is done
  float* y = reinterpret_cast<float*>(x);
#pragma unroll
  for (int i = 0; i < S::PER; ++i) {
    const int k = __brev(lane + i * G) >> (32 - S::LOG2Q);
    const float2 w = cmul(z[i], __ldg(post + k));
    y[2 * k] = epi(w.x);
    y[M - 1 - 2 * k] = epi(-w.y);
  }
}

}  // namespace mdctgan
