// K1: centre-padded MDCT spectrogram with the arcsinh + affine normalisation
// fused into the epilogue.
//
// Replaces mdctgan_tpu/ops/pallas_mdct.py:80 mdct_spectro_fused (TPU Pallas).
//   signal (B, T) f32  ->  out (B, F, M) f32,  M = N/2 = hop,
//   frame f = padded[f*M : f*M + N], padded = [M zeros, signal, zeros]
//   out = asinh(gain * (frame @ C)) / ln10 * scale + shift   (gain != 0)
//   out = (frame @ C) * scale + shift                         (gain == 0)
// C is the (N, M) cosine matrix with the KBD window folded in.
//
// mdct_spectro_launch: the FFT form, for power-of-two N in [64, 2048].
// Bound by bytes (mdct_fft.cuh: 0.62 us at the flagship shape on an H100
// SXM).  A block takes FRAMES consecutive frames of one batch row (4 for
// N >= 256).  It stages the (FRAMES + 1) * M samples they span into shared
// memory in one coalesced pass, zero outside [0, T), so the centre padding
// is never written.  Each frame's group of lanes windows and folds its
// samples to M values, runs the DCT-IV of mdct_fft.cuh with the epilogue
// applied once per output, and the block writes its FRAMES * M outputs, which
// are contiguous in `out`, in one coalesced pass.
//
// mdct_spectro_dense_launch: the dense form (window_gemm.cuh) for every
// other even N: the product with C on the tensor cores in 3xTF32.

#include "mdct_fft.cuh"
#include "window_gemm.cuh"

using namespace mdctgan;

namespace {

// asinh(u) = sign(u) log(|u| + sqrt(u^2 + 1)): a fraction of asinhf's
// instructions, within 1e-6 of float64 on the log scale over the values K1
// sees (tests/test_torch_mdct.py::test_kernel_asinh_sinh_formulas_in_float32).
struct AsinhAffine {
  float gain, scale, shift;
  __device__ __forceinline__ float operator()(float y) const {
    if (gain != 0.f) {
      const float u = gain * y;
      const float a = fabsf(u);
      y = copysignf(logf(a + sqrtf(fmaf(a, a, 1.f))), u) * (1.f / kLn10);
    }
    return y * scale + shift;
  }
};

template <int Q>
__global__ void __launch_bounds__(kFftThreads)
mdct_spectro_fft_kernel(const float* __restrict__ signal, long long t,
                        int n_frames, const float* __restrict__ tables,
                        float* __restrict__ out, AsinhAffine epi) {
  using S = FftShape<Q>;
  constexpr int M = S::M;
  constexpr int FRAMES = S::FRAMES;
  __shared__ float stage[(FRAMES + 1) * M];
  __shared__ float2 buf[FRAMES][Q];

  const FftTables<Q> tab(tables);
  const int f0 = blockIdx.x * FRAMES;
  const float* sig = signal + static_cast<long long>(blockIdx.y) * t;
  // all of a thread's loads are issued before the first store to shared
  // memory, so their latencies overlap
  constexpr int kStage = (FRAMES + 1) * M;
  constexpr int kPer = (kStage + kFftThreads - 1) / kFftThreads;
  const long long s0 = static_cast<long long>(f0 - 1) * M;
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kFftThreads;
    const long long g = s0 + e;
    v[i] = (e < kStage && g >= 0 && g < t) ? __ldg(sig + g) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kFftThreads;
    if (e < kStage) stage[e] = v[i];
  }
  __syncthreads();

  // frame f0 + r starts at stage[r * M]; x = w * frame, folded to
  // v = [-c_r - d, a - b_r] for the quarters a, b, c, d of x
  const int r = threadIdx.x / S::G;
  const float* fr = stage + r * M;
  const float* w = tab.window;
  auto x = [&](int n) { return __ldg(w + n) * fr[n]; };
  auto fold = [&](int j) {
    return j < Q ? -x(3 * Q - 1 - j) - x(3 * Q + j) : x(j - Q) - x(3 * Q - 1 - j);
  };
  dct4<Q>(buf[r], tab.pre, tab.roots, tab.post, threadIdx.x % S::G, fold, epi);
  __syncthreads();

  const int frames = min(FRAMES, n_frames - f0);
  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * M;
  const float* res = reinterpret_cast<const float*>(&buf[0][0]);
  for (int i = threadIdx.x; i < frames * M; i += kFftThreads) o[i] = res[i];
}

template <int Q>
int launch_fft(const float* signal, const float* tables, float* out, int batch,
               long long t, int n_frames, AsinhAffine epi, cudaStream_t stream) {
  constexpr int FRAMES = FftShape<Q>::FRAMES;
  const dim3 grid((n_frames + FRAMES - 1) / FRAMES, batch);
  mdct_spectro_fft_kernel<Q><<<grid, kFftThreads, 0, stream>>>(
      signal, t, n_frames, tables, out, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mdct_spectro_launch(const float* signal, const float* tables,
                                   float* out, int batch, long long t,
                                   int n_fft, int n_frames, float gain,
                                   float scale, float shift, void* stream) {
  const AsinhAffine epi{gain, scale, shift};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 64: return launch_fft<16>(signal, tables, out, batch, t, n_frames, epi, s);
    case 128: return launch_fft<32>(signal, tables, out, batch, t, n_frames, epi, s);
    case 256: return launch_fft<64>(signal, tables, out, batch, t, n_frames, epi, s);
    case 512: return launch_fft<128>(signal, tables, out, batch, t, n_frames, epi, s);
    case 1024: return launch_fft<256>(signal, tables, out, batch, t, n_frames, epi, s);
    case 2048: return launch_fft<512>(signal, tables, out, batch, t, n_frames, epi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dense form: `wop` is dense_operand of spectro_matrix(N)'s two halves
// of hop rows (ops/mdct_kernels.py, in fragment order); frame f of batch
// row b is row f of the product.
template <int PASSES>
int launch_dense(const float* signal, const float* wop, float* out, int batch, long long t,
                 int n_fft, int n_frames, float gain, float scale, float shift,
                 void* stream) {
  if (n_fft < 2 || n_fft % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int hop = n_fft / 2;
  return dense::window_gemm<PASSES>(signal, t, n_frames, hop, hop, /*offset=*/hop, wop,
                                    out, batch, Identity{}, AsinhAffine{gain, scale, shift},
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int mdct_spectro_dense_launch(const float* signal, const float* wop,
                                         float* out, int batch, long long t,
                                         int n_fft, int n_frames, float gain,
                                         float scale, float shift, void* stream) {
  return launch_dense<3>(signal, wop, out, batch, t, n_fft, n_frames, gain, scale, shift,
                         stream);
}

// 1xTF32 (hi x hi only): the accuracy control of chip_smoke.py, on no path.
extern "C" int mdct_spectro_dense_tf32x1_launch(const float* signal, const float* wop,
                                                float* out, int batch, long long t,
                                                int n_fft, int n_frames, float gain,
                                                float scale, float shift, void* stream) {
  return launch_dense<1>(signal, wop, out, batch, t, n_fft, n_frames, gain, scale, shift,
                         stream);
}
