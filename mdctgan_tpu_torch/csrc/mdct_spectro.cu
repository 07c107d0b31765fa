// K1: centre-padded MDCT spectrogram with the arcsinh + affine normalisation
// fused into the epilogue.
//
// Replaces mdctgan_tpu/ops/pallas_mdct.py:mdct_spectro_fused (TPU Pallas).
//   signal (B, T) f32  ->  out (B, F, N/2) f32,  hop = N/2,
//   frame f = padded[f*hop : f*hop + N], padded = [hop zeros, signal, zeros]
//   out = asinh(gain * (frame @ M)) / ln10 * scale + shift   (gain != 0)
//   out = (frame @ M) * scale + shift                         (gain == 0)
// M is the (N, N/2) cosine matrix with the KBD window folded in.  Frames are
// read straight from the unpadded signal (zero outside [0, T)), so no padded
// or framed copy is written.  Bound: see window_gemm.cuh (FMA-bound).

#include "window_gemm.cuh"

namespace {

struct AsinhAffine {
  float gain, scale, shift;
  __device__ __forceinline__ float operator()(float y) const {
    if (gain != 0.f) y = asinhf(gain * y) * (1.f / mdctgan::kLn10);
    return y * scale + shift;
  }
};

}  // namespace

extern "C" int mdct_spectro_launch(const float* signal, const float* mat,
                                   float* out, int batch, long long t,
                                   int n_fft, int n_frames, float gain,
                                   float scale, float shift, void* stream) {
  using namespace mdctgan;
  const int hop = n_fft / 2;
  window_gemm_kernel<<<window_gemm_grid(n_frames, hop, batch), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      signal, t, n_frames, n_fft, hop, /*row_stride=*/hop, /*offset=*/hop,
      RowMajorW{mat, hop}, out, Identity{}, AsinhAffine{gain, scale, shift});
  return static_cast<int>(cudaGetLastError());
}
