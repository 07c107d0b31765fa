// Sliding-window matrix product on the tensor cores: the dense form of the
// MDCT (K1) and IMDCT (K2) kernels, for the N that the FFT form
// (mdct_fft.cuh) does not take, i.e. any even N that is not a power of two
// in [64, 2048].  For those N it replaces mdctgan_tpu/ops/pallas_mdct.py:80
// (mdct_spectro_fused) and pallas_mdct.py:185 (imdct_audio_fused).
//
//   out[b, r, n] = epi( sum_{d < 2 hop} pro(src[b, r*hop + d - offset]) * W(d, n) )
//
// Row r of the left operand is a window of 2*hop source values that starts
// hop after row r-1's, so the depth falls into two halves of hop values:
// half h of row r is source chunk r + h.  Both transforms have this form:
//   * K1 (MDCT): a frame is N = 2 hop consecutive samples of the
//     centre-padded signal, offset = hop.  The padding is never written: a
//     source index outside [0, src_len) reads as zero.
//   * K2 (IMDCT + overlap-add): output chunk c is frames[c, hop:] +
//     frames[c+1, :hop], i.e. the row [x[c], x[c+1]] times
//     [S[:, hop:]; S[:, :hop]], offset = 0.  No atomics.
//
// Bound on an H100 SXM: the function is bound by bytes (each input read and
// each output written once: 0.62 us at N 512, batch 8, 128 frames), but
// this form does the dense product, 2*hop*hop multiply-adds an output value
// (268 MFLOP at that shape, 944 MFLOP at N 960).  The design takes it to
// the TF32 tensor cores (mma.sync m16n8k8) in 3xTF32:
//   * A block owns BM consecutive rows of one batch row and BN = 32
//     columns.  It stages the (BM + 1) * hop source values its rows span
//     once, by cp.async (zero-filled outside [0, src_len)), and applies
//     `pro` (K2's affine + sinh) once to each staged value, one warp a
//     chunk, 8 values a lane in flight.  Chunk c lives at span[c * P],
//     P = hop_pad + 4 = 4 (mod 8), so the eight row groups of an A fragment
//     fall on distinct banks; the chunk's tail [hop, hop_pad) is zeroed.
//   * W streams through a STAGES-deep cp.async ring, BK = 32 depth values of
//     both halves a stage (8 KB).  The host lays it out in fragment order
//     (ops/mdct_kernels.py dense_operand), so that a lane reads its (b0, b1)
//     as one conflict-free float2.
//   * 8 warps: warps 0-3 take depth half 0, warps 4-7 half 1.  Of the 4
//     warps of a half, BM / 16 share the rows (16 each) and the others the
//     k8 steps of each stage; every warp owns all 32 columns, so one A
//     fragment feeds 4 n8 tiles.  The warps' sums meet in shared memory and
//     the epilogue writes each row of the tile as 32 neighbouring floats.
//   * 3xTF32: a = a_hi + a_lo, w = w_hi + w_lo (each part rounded to TF32,
//     to nearest, by two integer operations), acc += a_lo w_hi + a_hi w_lo
//     + a_hi w_hi.  The tensor cores truncate where they add, so every two
//     k8 steps (16 depth values) sum into fresh register tiles that are
//     then added to the float32 accumulator, rounded to nearest: summed
//     straight into the accumulator, the truncation builds up over the
//     depth (probes/tf32_accumulation_model.py).  The arcsinh of gain 1000
//     (slope ~87 at 0) and the sinh (slope up to ~575) need float32
//     accuracy; 1xTF32 (PASSES = 1, chip_smoke.py's control only) shows
//     what the split buys.
//   * BM is the largest of 64, 32, 16 whose grid puts a block on every SM
//     and of which two blocks fit an SM (the serving batch of 8 gives 256
//     blocks of 32 rows at N 512 and 480 at N 960).
// Measured on an H100 (ops/kernel_probe.py; PERF.md): the tensor cores are
// not what bounds it.  At N 960, batch 8, the same kernel without any mma
// takes ~80% of its time and 1xTF32 ~75%: the warps' chains of fragment
// loads, TF32 splits and dependent mma between the per-stage barriers, and
// for K2 the sinh of each staged value, once per column tile.  wgmma with
// operands in shared memory is the next step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mdct_fft.cuh"

namespace mdctgan {
namespace dense {

constexpr int BN = 32;                  // output columns per block
constexpr int BK = 32;                  // depth values of each half per stage
constexpr int KK = BK / 8;              // m16n8k8 steps per stage
constexpr int NTILES = BN / 8;          // n8 tiles per block, all of one warp's
constexpr int THREADS = 256;            // 8 warps: 2 depth halves x 4
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 5;               // depth of the W ring
constexpr int STAGE_FLOATS = 2 * KK * NTILES * 32 * 2;  // one ring slot, 8 KB
constexpr int PRO_UNROLL = 8;           // staged values a lane denormalises at once
constexpr int RED_PITCH = BN + 8;       // the warps' sums, float2 stores

__host__ __device__ inline int hop_pad(int hop) { return (hop + BK - 1) / BK * BK; }
__host__ __device__ inline int span_pitch(int hop) { return hop_pad(hop) + 4; }

inline size_t smem_bytes(int bm, int hop) {
  const int span = (bm + 1) * span_pitch(hop);
  const int red = WARPS * 16 * RED_PITCH;
  return sizeof(float) * (STAGES * STAGE_FLOATS + (span > red ? span : red));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32):
// the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each rounded to TF32 (x to 2^-22); lo only for 3xTF32.
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  if (PASSES == 3) lo = tf32(x - __uint_as_float(hi));
}

// d += a * b over one m16n8k8 tile, TF32 inputs, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One ring slot of W: STAGE_FLOATS contiguous floats of the operand.
__device__ __forceinline__ void load_stage(float* dst, const float* src) {
#pragma unroll
  for (int i = threadIdx.x; i < STAGE_FLOATS / 4; i += THREADS)
    cp_async16(dst + 4 * i, src + 4 * i, true);
}

// The BM + 1 source chunks of the block, chunk c from j0 + c * hop, into
// span[c * P + e], zero outside [0, src_len), one warp a chunk.  16-byte
// copies where every chunk and the batch row are 4-float aligned, else
// 4-byte ones.
template <int BM>
__device__ __forceinline__ void stage_span(float* span, const float* sb, long long src_len,
                                           long long j0, int hop, int P, bool vec) {
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c <= BM; c += WARPS) {
    const long long base = j0 + static_cast<long long>(c) * hop;
    float* row = span + c * P;
    if (vec) {
      for (int e = 4 * lane; e < hop; e += 128) {
        const bool ok = base + e >= 0 && base + e < src_len;
        cp_async16(row + e, ok ? sb + base + e : sb, ok);
      }
    } else {
      for (int e = lane; e < hop; e += 32) {
        const bool ok = base + e >= 0 && base + e < src_len;
        cp_async4(row + e, ok ? sb + base + e : sb, ok);
      }
    }
  }
}

// pro once on each staged value of the span that lies in [0, src_len), and
// the chunk tails [hop, hop_pad) zeroed: one warp a chunk, PRO_UNROLL values
// a lane in flight.
template <int BM, class Pro>
__device__ __forceinline__ void pro_span(float* span, long long j0, int hop, int hp, int P,
                                         long long src_len, Pro pro) {
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c <= BM; c += WARPS) {
    float* row = span + c * P;
    if constexpr (!std::is_same<Pro, Identity>::value) {
      const long long base = j0 + static_cast<long long>(c) * hop;
      // the columns of this chunk inside the source
      const int lo = base < 0 ? static_cast<int>(-base) : 0;
      const int hi = base + hop > src_len ? static_cast<int>(src_len - base) : hop;
      for (int e0 = lo; e0 < hi; e0 += 32 * PRO_UNROLL) {
        float v[PRO_UNROLL];
#pragma unroll
        for (int u = 0; u < PRO_UNROLL; ++u) {
          const int e = e0 + u * 32 + lane;
          v[u] = e < hi ? row[e] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < PRO_UNROLL; ++u) {
          const int e = e0 + u * 32 + lane;
          if (e < hi) row[e] = pro(v[u]);
        }
      }
    }
    for (int e = hop + lane; e < hp; e += 32) row[e] = 0.f;
  }
}

// grid (ceil(rows / BM), ceil(width / BN), batch), THREADS threads,
// smem_bytes(BM, hop) of dynamic shared memory.  `wop` is the operand of
// ops/mdct_kernels.py dense_operand: for column tile j and stage s, the
// STAGE_FLOATS floats at (j * n_stages + s) * STAGE_FLOATS, ordered
// [half][k8 step][n8 tile][lane][w(k), w(k + 4)] with k = 8 * step + lane % 4
// and column n8 * 8 + lane / 4.
//
// Warp w takes depth half h = w / 4 and, of the 4 warps of its half,
// WARPS_M = BM / 16 share the rows (16 each) and KSPLIT = 4 / WARPS_M share
// the k8 steps of every stage (step % KSPLIT); each warp owns all BN
// columns, so one A fragment, split once, feeds 4 n8 tiles.
template <int BM, int PASSES, class Pro, class Epi>
__global__ void __launch_bounds__(THREADS, 2)
window_gemm_kernel(const float* __restrict__ src, long long src_len, int rows, int hop,
                   int width, int offset, bool vec, const float* __restrict__ wop,
                   float* __restrict__ out, Pro pro, Epi epi) {
  static_assert(PASSES == 1 || PASSES == 3, "1xTF32 or 3xTF32");
  constexpr int WARPS_M = BM / 16;
  constexpr int KSPLIT = 4 / WARPS_M;
  constexpr int STEPS = KK / KSPLIT;  // this warp's k8 steps a stage
  constexpr int RESET = STEPS < 2 ? STEPS : 2;  // k8 steps before a rounded add
  static_assert(WARPS_M * KSPLIT == 4 && KK % KSPLIT == 0, "warp roles");

  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* span = smem + STAGES * STAGE_FLOATS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = warp >> 2;  // depth half
  const int wm = (warp & 3) % WARPS_M;
  const int ks = (warp & 3) / WARPS_M;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hp = hop_pad(hop);
  const int P = hp + 4;
  const int n_stages = hp / BK;
  const int r0 = blockIdx.x * BM;
  const long long j0 = static_cast<long long>(r0) * hop - offset;
  const float* sb = src + static_cast<long long>(blockIdx.z) * src_len;
  const float* wt = wop + static_cast<long long>(blockIdx.y) * n_stages * STAGE_FLOATS;

  stage_span<BM>(span, sb, src_len, j0, hop, P, vec);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(ring + s * STAGE_FLOATS, wt + s * STAGE_FLOATS);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // the span's group
  __syncthreads();
  pro_span<BM>(span, j0, hop, hp, P, src_len, pro);

  float acc[NTILES][4];
#pragma unroll
  for (int jn = 0; jn < NTILES; ++jn)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[jn][q] = 0.f;

  // this warp's A rows: local row wm * 16 + g (+ 8), chunk + h
  const float* arow = span + (wm * 16 + g + h) * P + t;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = s + STAGES - 1;
    if (next < n_stages)
      load_stage(ring + (next % STAGES) * STAGE_FLOATS, wt + next * STAGE_FLOATS);
    cp_async_commit();

    const float* slot = ring + (s % STAGES) * STAGE_FLOATS + lane * 2;
#pragma unroll
    for (int k0 = 0; k0 < STEPS; k0 += RESET) {
      // hi x hi and the two small products in separate chains
      float part[NTILES][4], corr[NTILES][4];
#pragma unroll
      for (int jn = 0; jn < NTILES; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[jn][q] = corr[jn][q] = 0.f;
#pragma unroll
      for (int k1 = k0; k1 < k0 + RESET; ++k1) {
        const int kk = k1 * KSPLIT + ks;
        const float* p = arow + s * BK + kk * 8;
        uint32_t ahi[4], alo[4];
        split<PASSES>(p[0], ahi[0], alo[0]);
        split<PASSES>(p[8 * P], ahi[1], alo[1]);
        split<PASSES>(p[4], ahi[2], alo[2]);
        split<PASSES>(p[8 * P + 4], ahi[3], alo[3]);
#pragma unroll
        for (int jn = 0; jn < NTILES; ++jn) {
          const float2 w =
              *reinterpret_cast<const float2*>(slot + ((h * KK + kk) * NTILES + jn) * 64);
          uint32_t bhi[2], blo[2];
          split<PASSES>(w.x, bhi[0], blo[0]);
          split<PASSES>(w.y, bhi[1], blo[1]);
          if (PASSES == 3) {
            mma_tf32(corr[jn], alo, bhi[0], bhi[1]);
            mma_tf32(corr[jn], ahi, blo[0], blo[1]);
          }
          mma_tf32(part[jn], ahi, bhi[0], bhi[1]);
        }
      }
#pragma unroll
      for (int jn = 0; jn < NTILES; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[jn][q] += part[jn][q] + corr[jn][q];
    }
  }

  // the warps' sums meet in shared memory (the span's place): warp w's
  // 16 x BN tile at red[w * 16 * RED_PITCH]
  cp_async_wait<0>();
  __syncthreads();
  float* red = span + warp * 16 * RED_PITCH;
#pragma unroll
  for (int jn = 0; jn < NTILES; ++jn) {
    const int n = jn * 8 + 2 * t;
    *reinterpret_cast<float2*>(red + g * RED_PITCH + n) = make_float2(acc[jn][0], acc[jn][1]);
    *reinterpret_cast<float2*>(red + (g + 8) * RED_PITCH + n) =
        make_float2(acc[jn][2], acc[jn][3]);
  }
  __syncthreads();

  float* ob = out + static_cast<long long>(blockIdx.z) * rows * width;
  const int n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int m = i / BN, c = i - m * BN;
    const int r = r0 + m, n = n0 + c;
    if (r < rows && n < width) {
      // the warps holding row m: (h, ks) over 2 * KSPLIT, wm = m / 16
      float sum = 0.f;
#pragma unroll
      for (int hk = 0; hk < 2 * KSPLIT; ++hk) {
        const int w = (hk / KSPLIT) * 4 + (hk % KSPLIT) * WARPS_M + m / 16;
        sum += span[(w * 16 + m % 16) * RED_PITCH + c];
      }
      ob[static_cast<long long>(r) * width + n] = epi(sum);
    }
  }
}

template <int BM, int PASSES, class Pro, class Epi>
int launch_bm(const float* src, long long src_len, int rows, int hop, int width, int offset,
              bool vec, const float* wop, float* out, int batch, Pro pro, Epi epi,
              int dev, int max_smem, cudaStream_t stream) {
  auto kernel = window_gemm_kernel<BM, PASSES, Pro, Epi>;
  // once per device: allow the opt-in maximum of dynamic shared memory
  static bool ready[64] = {};
  if (dev >= 64 || !ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid((rows + BM - 1) / BM, (width + BN - 1) / BN, batch);
  kernel<<<grid, THREADS, smem_bytes(BM, hop), stream>>>(
      src, src_len, rows, hop, width, offset, vec, wop, out, pro, epi);
  return static_cast<int>(cudaGetLastError());
}

// The whole product for `batch` source rows of src_len values each; returns
// a cudaError_t.  Chooses BM (see the header comment); cudaErrorInvalidValue
// if even 16 rows of this hop do not fit in shared memory.
template <int PASSES, class Pro, class Epi>
int window_gemm(const float* src, long long src_len, int rows, int hop, int width,
                int offset, const float* wop, float* out, int batch, Pro pro, Epi epi,
                cudaStream_t stream) {
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int sm_smem = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || batch <= 0) return 0;
  const long long cols = (width + BN - 1) / BN;
  // the largest BM whose grid puts a block on every SM and of which two
  // blocks fit an SM; else the smallest that fits
  int bm = 0;
  for (int cand : {64, 32, 16}) {
    if (smem_bytes(cand, hop) > static_cast<size_t>(max_smem)) continue;
    bm = cand;
    if ((rows + cand - 1) / cand * cols * batch >= sms &&
        2 * (smem_bytes(cand, hop) + 1024) <= static_cast<size_t>(sm_smem))
      break;
  }
  const bool vec = hop % 4 == 0 && src_len % 4 == 0 && offset % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  switch (bm) {
    case 64:
      return launch_bm<64, PASSES>(src, src_len, rows, hop, width, offset, vec, wop, out,
                                   batch, pro, epi, dev, max_smem, stream);
    case 32:
      return launch_bm<32, PASSES>(src, src_len, rows, hop, width, offset, vec, wop, out,
                                   batch, pro, epi, dev, max_smem, stream);
    case 16:
      return launch_bm<16, PASSES>(src, src_len, rows, hop, width, offset, vec, wop, out,
                                   batch, pro, epi, dev, max_smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dense
}  // namespace mdctgan
