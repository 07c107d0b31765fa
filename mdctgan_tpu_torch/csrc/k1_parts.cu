// K1's FFT form at N = 512 cut into parts, for ops/kernel_probe.py: the
// same grid, block and staging as mdct_spectro_fft_kernel<128>, stopped
// after part PART:
//   0  return at once (the launch and the grid alone)
//   1  stage the samples and store them as the output (the memory traffic)
//   2  1 + the fold and the DCT-IV with no epilogue
//   3  2 + the asinh/affine epilogue: the kernel itself
// Not on any path of the port; it only measures.

#include "mdct_spectro.cu"

namespace {

template <int PART>
__global__ void __launch_bounds__(kFftThreads)
k1_part_kernel(const float* __restrict__ signal, long long t, int n_frames,
               const float* __restrict__ tables, float* __restrict__ out,
               AsinhAffine epi) {
  constexpr int Q = 128;
  using S = FftShape<Q>;
  constexpr int M = S::M;
  constexpr int FRAMES = S::FRAMES;
  __shared__ float stage[(FRAMES + 1) * M];
  __shared__ float2 buf[FRAMES][Q];
  if (PART == 0) return;

  const FftTables<Q> tab(tables);
  const int f0 = blockIdx.x * FRAMES;
  const float* sig = signal + static_cast<long long>(blockIdx.y) * t;
  constexpr int kPer = (FRAMES + 1) * M / kFftThreads;
  const long long s0 = static_cast<long long>(f0 - 1) * M;
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long g = s0 + threadIdx.x + i * kFftThreads;
    v[i] = (g >= 0 && g < t) ? __ldg(sig + g) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) stage[threadIdx.x + i * kFftThreads] = v[i];
  __syncthreads();

  const float* res = stage;
  if (PART >= 2) {
    const int r = threadIdx.x / S::G;
    const float* fr = stage + r * M;
    const float* w = tab.window;
    auto x = [&](int n) { return __ldg(w + n) * fr[n]; };
    auto fold = [&](int j) {
      return j < Q ? -x(3 * Q - 1 - j) - x(3 * Q + j) : x(j - Q) - x(3 * Q - 1 - j);
    };
    if (PART == 2)
      dct4<Q>(buf[r], tab.pre, tab.roots, tab.post, threadIdx.x % S::G, fold, Identity{});
    else
      dct4<Q>(buf[r], tab.pre, tab.roots, tab.post, threadIdx.x % S::G, fold, epi);
    __syncthreads();
    res = reinterpret_cast<const float*>(&buf[0][0]);
  }
  const int frames = min(FRAMES, n_frames - f0);
  float* o = out + (static_cast<long long>(blockIdx.y) * n_frames + f0) * M;
  for (int i = threadIdx.x; i < frames * M; i += kFftThreads) o[i] = res[i];
}

}  // namespace

// signal (B, T), tables of fft_tables(512), out (B, F, 256) as for K1.
extern "C" int k1_parts_launch(int part, const float* signal,
                               const float* tables, float* out, int batch,
                               long long t, int n_frames, float gain,
                               float scale, float shift, void* stream) {
  const dim3 grid((n_frames + FftShape<128>::FRAMES - 1) / FftShape<128>::FRAMES, batch);
  const AsinhAffine epi{gain, scale, shift};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (part) {
    case 0: k1_part_kernel<0><<<grid, kFftThreads, 0, s>>>(signal, t, n_frames, tables, out, epi); break;
    case 1: k1_part_kernel<1><<<grid, kFftThreads, 0, s>>>(signal, t, n_frames, tables, out, epi); break;
    case 2: k1_part_kernel<2><<<grid, kFftThreads, 0, s>>>(signal, t, n_frames, tables, out, epi); break;
    case 3: k1_part_kernel<3><<<grid, kFftThreads, 0, s>>>(signal, t, n_frames, tables, out, epi); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
