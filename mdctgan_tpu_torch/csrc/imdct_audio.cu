// K2: denormalisation + IMDCT + centre-cropped overlap-add in one pass.
//
// Replaces mdctgan_tpu/ops/pallas_mdct.py:185 imdct_audio_fused (TPU Pallas).
//   spec (B, F, M) f32 normalised, M = N/2 = hop  ->  out (B, (F-1)*M) f32
//   x      = sinh((spec * scale + shift) * ln10) / gain   (gain != 0; else affine only)
//   frames = x @ S,  S = (4/N) * (w * C)^T  of shape (M, N)
//   out[c] = frames[c, M:] + frames[c+1, :M]
//
// imdct_audio_launch: the FFT form, for power-of-two N in [64, 2048].
// Bound by bytes (mdct_fft.cuh: 0.62 us at the flagship shape on an H100
// SXM).  A block takes R = FRAMES - 1 consecutive output chunks (3 for
// N >= 256) and computes the FRAMES frames they need; the one halo frame is
// recomputed by the neighbouring block.  It stages the FRAMES * M spectrum
// values, contiguous in `spec`, in one coalesced pass and denormalises each
// exactly once as it is staged.  Each frame's group of lanes runs the DCT-IV
// of mdct_fft.cuh in place (4/N folded into post_inv), giving u; the frame
// is w * [A, -A_r, -B_r, -B] with A = u[Q:], B = u[:Q].  The block then
// writes its R * M output samples, each the sum of its two windowed
// half-frames, in one coalesced pass: no atomics, no frame tensor.
//
// imdct_audio_dense_launch: the dense form (window_gemm.cuh) for every other
// even N: [x[c], x[c+1]] times [S[:, k:]; S[:, :k]] on the tensor cores in
// 3xTF32, each spectrum value denormalised once as it is staged.

#include "mdct_fft.cuh"
#include "window_gemm.cuh"

using namespace mdctgan;

namespace {

// sinh(t) = (e^t - e^-t) / 2 with one expf: a fraction of sinhf's
// instructions, within 5e-7 relative (plus 5e-10 absolute near t = 0) of
// float64 over the values K2 sees
// (tests/test_torch_mdct.py::test_kernel_asinh_sinh_formulas_in_float32).
struct AffineSinh {
  float gain, scale, shift;
  __device__ __forceinline__ float operator()(float y) const {
    float x = y * scale + shift;
    if (gain != 0.f) {
      const float e = expf(x * kLn10);
      x = (e - __frcp_rn(e)) * (0.5f / gain);
    }
    return x;
  }
};

template <int Q>
__global__ void __launch_bounds__(kFftThreads)
imdct_audio_fft_kernel(const float* __restrict__ spec, int n_frames,
                       const float* __restrict__ tables,
                       float* __restrict__ out, AffineSinh pro) {
  using S = FftShape<Q>;
  constexpr int M = S::M;
  constexpr int FRAMES = S::FRAMES;
  constexpr int R = FRAMES - 1;
  __shared__ float2 buf[FRAMES][Q];
  float* st = reinterpret_cast<float*>(&buf[0][0]);

  const FftTables<Q> tab(tables);
  const int c0 = blockIdx.x * R;
  const float* sp = spec + (static_cast<long long>(blockIdx.y) * n_frames + c0) * M;
  const int avail = min(FRAMES, n_frames - c0) * M;
  // all of a thread's loads are issued before the first store to shared
  // memory, so their latencies overlap
  constexpr int kPer = FRAMES * M / kFftThreads;
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kFftThreads;
    v[i] = e < avail ? __ldg(sp + e) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kFftThreads;
    st[e] = e < avail ? pro(v[i]) : 0.f;
  }
  __syncthreads();

  const int r = threadIdx.x / S::G;
  const float* xr = st + r * M;
  dct4<Q>(buf[r], tab.pre, tab.roots, tab.post_inv, threadIdx.x % S::G,
          [&](int j) { return xr[j]; }, Identity{});
  __syncthreads();

  // chunk c0 + i = second half of frame i + first half of frame i + 1
  const int chunks = min(R, n_frames - 1 - c0);
  float* o = out + (static_cast<long long>(blockIdx.y) * (n_frames - 1) + c0) * M;
  const float* w = tab.window;
  for (int e = threadIdx.x; e < chunks * M; e += kFftThreads) {
    const int n = e % M;
    const float* u0 = st + (e - n);
    const float* u1 = u0 + M;
    const float h1 = n < Q ? -u0[Q - 1 - n] : -u0[n - Q];
    const float h0 = n < Q ? u1[Q + n] : -u1[3 * Q - 1 - n];
    o[e] = fmaf(h1, __ldg(w + M + n), h0 * __ldg(w + n));
  }
}

template <int Q>
int launch_fft(const float* spec, const float* tables, float* out, int batch,
               int n_frames, AffineSinh pro, cudaStream_t stream) {
  constexpr int R = FftShape<Q>::FRAMES - 1;
  const dim3 grid((n_frames - 1 + R - 1) / R, batch);
  imdct_audio_fft_kernel<Q><<<grid, kFftThreads, 0, stream>>>(
      spec, n_frames, tables, out, pro);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int imdct_audio_launch(const float* spec, const float* tables,
                                  float* out, int batch, int n_frames,
                                  int n_fft, float gain, float scale,
                                  float shift, void* stream) {
  const AffineSinh pro{gain, scale, shift};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 64: return launch_fft<16>(spec, tables, out, batch, n_frames, pro, s);
    case 128: return launch_fft<32>(spec, tables, out, batch, n_frames, pro, s);
    case 256: return launch_fft<64>(spec, tables, out, batch, n_frames, pro, s);
    case 512: return launch_fft<128>(spec, tables, out, batch, n_frames, pro, s);
    case 1024: return launch_fft<256>(spec, tables, out, batch, n_frames, pro, s);
    case 2048: return launch_fft<512>(spec, tables, out, batch, n_frames, pro, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dense form: `wop` is dense_operand of [S[:, k:]; S[:, :k]] (the
// overlap-add folded into the matrix, ops/mdct_kernels.py); output chunk c
// of batch row b is row c of the product over the flat spectrum.
template <int PASSES>
int launch_dense(const float* spec, const float* wop, float* out, int batch, int n_frames,
                 int n_fft, float gain, float scale, float shift, void* stream) {
  if (n_fft < 2 || n_fft % 2 || n_frames < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int k = n_fft / 2;
  return dense::window_gemm<PASSES>(spec, static_cast<long long>(n_frames) * k, n_frames - 1,
                                    k, k, /*offset=*/0, wop, out, batch,
                                    AffineSinh{gain, scale, shift}, Identity{},
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int imdct_audio_dense_launch(const float* spec, const float* wop,
                                        float* out, int batch, int n_frames,
                                        int n_fft, float gain, float scale,
                                        float shift, void* stream) {
  return launch_dense<3>(spec, wop, out, batch, n_frames, n_fft, gain, scale, shift, stream);
}

// 1xTF32 (hi x hi only): the accuracy control of chip_smoke.py, on no path.
extern "C" int imdct_audio_dense_tf32x1_launch(const float* spec, const float* wop,
                                               float* out, int batch, int n_frames,
                                               int n_fft, float gain, float scale,
                                               float shift, void* stream) {
  return launch_dense<1>(spec, wop, out, batch, n_frames, n_fft, gain, scale, shift, stream);
}
