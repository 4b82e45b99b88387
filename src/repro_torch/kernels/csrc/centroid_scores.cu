// Masked centroid inner products: the IVF coarse probe's scores, reached
// through kernels/ops.py centroid_probe (then torch.topk picks the nprobe
// clusters), as the reference reaches its kernel through ops.centroid_probe.
//
// Replaces: src/repro/kernels/centroid_probe.py, centroid_scores (Pallas
//           body _kernel).
//
// Bound on an H100: bytes.  The work is one pass over the valid centroid
// rows (Nc * d fp32) and 2 * B flops per value; at the serve shape (B=4,
// d=768, Nc=1024) that is 3.1 MB and 6.3 MFLOP, 1.5 flop per byte read.
// The TPU kernel keeps the queries in VMEM and streams centroid tiles
// through the MXU; here the queries sit in shared memory as fp32 and one
// warp takes one centroid row: its 32 lanes read the row in coalesced
// steps, FMA it against every query of the group in fp32 (no TF32: the
// cut at nprobe must not move) and reduce each sum with shuffles.  An invalid centroid's row is never read; its scores are
// -inf.  Any Nc works (the TPU tiling's padding is gone); queries are
// staged in chunks that fit a block's default 48 KB of shared memory
// (d up to 12,288).
// Not done yet (later work): several rows per warp, 16-byte loads.
//
// Layouts: q [B, d] fp32; centroids [Nc, d] fp32; valid [Nc] one byte each
// (null = every centroid valid); out [B, Nc] fp32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQR = 8;                   // queries summed per pass over a row
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q_s holds the chunk's nq <= qb query rows of d floats.  A pass sums kQR
// queries at once; a pass past the chunk's last query repeats that row
// and drops the sum, so no padding is staged.
__global__ void __launch_bounds__(kThreads)
centroid_scores_kernel(const float* __restrict__ q, const float* __restrict__ cent,
                       const uint8_t* __restrict__ valid, float* __restrict__ out,
                       int B, int d, int Nc, int qb) {
  extern __shared__ float q_s[];
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = c < Nc && (valid == nullptr || valid[c] != 0);
  const float* row = cent + (long long)c * d;

  for (int q0 = 0; q0 < B; q0 += qb) {
    const int nq = min(qb, B - q0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = threadIdx.x; e < nq * d; e += kThreads)
      q_s[e] = q[(long long)q0 * d + e];
    __syncthreads();
    if (c >= Nc) continue;
    for (int r0 = 0; r0 < nq; r0 += kQR) {
      float acc[kQR];
      int off[kQR];
#pragma unroll
      for (int r = 0; r < kQR; ++r) {
        acc[r] = 0.f;
        off[r] = min(r0 + r, nq - 1) * d;
      }
      if (live) {
        for (int e = lane; e < d; e += 32) {
          const float x = row[e];
#pragma unroll
          for (int r = 0; r < kQR; ++r) acc[r] = fmaf(q_s[off[r] + e], x, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kQR; ++r) {
        const float s = warp_sum(acc[r]);
        if (lane == 0 && r0 + r < nq)
          out[(long long)(q0 + r0 + r) * Nc + c] = live ? s : -INFINITY;
      }
    }
  }
}

}  // namespace

extern "C" int centroid_scores(const float* q, const float* centroids,
                               const uint8_t* valid, float* out, int B, int d, int Nc,
                               void* stream) {
  if (d < 1 || (long long)d * 4 > kSmemBytes) return (int)cudaErrorInvalidValue;
  if (B == 0 || Nc == 0) return 0;
  const int fit = kSmemBytes / (d * 4);          // queries staged per chunk
  const int qb = B < fit ? B : fit;
  const dim3 grid((Nc + kWarps - 1) / kWarps);
  centroid_scores_kernel<<<grid, kThreads, (size_t)qb * d * 4,
                           static_cast<cudaStream_t>(stream)>>>(q, centroids, valid, out,
                                                                B, d, Nc, qb);
  return (int)cudaGetLastError();
}
