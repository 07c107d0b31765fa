// K2: denormalisation + IMDCT + centre-cropped overlap-add in one pass.
//
// Replaces mdctgan_tpu/ops/pallas_mdct.py:imdct_audio_fused (TPU Pallas).
//   spec (B, F, K) f32 normalised, K = N/2 = hop  ->  out (B, (F-1)*hop) f32
//   x      = sinh((spec * scale + shift) * ln10) / gain   (gain != 0; else affine only)
//   frames = x @ S,  S = (4/N) * (w * C)^T  of shape (K, N)
//   out[c] = frames[c, hop:] + frames[c+1, :hop]
// Written as one product per output chunk: row c of the left operand is
// [x[c], x[c+1]], which is 2K consecutive values of the flattened spectrum,
// and the right operand is [S[:, hop:]; S[:, :hop]] read in place from S.
// Each output sample sums its two half-frames inside one dot product, so no
// atomics and no frame tensor.  The prologue denormalises each spectrum
// value as it is staged.  Bound: see window_gemm.cuh (FMA-bound).

#include "window_gemm.cuh"

namespace {

struct AffineSinh {
  float gain, scale, shift;
  __device__ __forceinline__ float operator()(float y) const {
    float x = y * scale + shift;
    if (gain != 0.f) x = sinhf(x * mdctgan::kLn10) / gain;
    return x;
  }
};

// W(d, n) of [S[:, hop:]; S[:, :hop]] for S of shape (k, 2k), hop = k.
struct OverlapAddW {
  const float* s;
  int k;
  __device__ __forceinline__ float operator()(int d, int n) const {
    const long long row = 2LL * k;
    return d < k ? __ldg(s + d * row + k + n) : __ldg(s + (d - k) * row + n);
  }
};

}  // namespace

extern "C" int imdct_audio_launch(const float* spec, const float* synth,
                                  float* out, int batch, int n_frames,
                                  int n_fft, float gain, float scale,
                                  float shift, void* stream) {
  using namespace mdctgan;
  const int k = n_fft / 2;
  const int rows = n_frames - 1;
  window_gemm_kernel<<<window_gemm_grid(rows, k, batch), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      spec, static_cast<long long>(n_frames) * k, rows, n_fft, k,
      /*row_stride=*/k, /*offset=*/0, OverlapAddW{synth, k}, out,
      AffineSinh{gain, scale, shift}, Identity{});
  return static_cast<int>(cudaGetLastError());
}
