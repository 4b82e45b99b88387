// Fused IVF retrieval over the resident pool pages: centroid probe,
// top-nprobe cluster admission, masked inner product and top-k.
//
// Replaces: src/repro/kernels/probe_topk.py, probe_topk_fused
//           (Pallas body _kernel).
//
// Bound on an H100: bytes.  The work is one pass over the pool pages that
// some query admits (ps * d bf16 values per page, 2 * B flops per value)
// plus the [Nc, d] centroids, far below the ~20 flop/byte at which even
// the fp32 CUDA cores would limit.  The TPU kernel's one sequential grid
// (probe tiles, then page tiles) becomes two grids on the stream:
//   (a) probe_kernel, spread over the card: one warp per centroid, eight
//       a block, each reading its fp32 row once with 16-byte loads for
//       all B queries and writing the masked [B, Nc] scores to scratch
//       (a finite -1e30 sentinel on invalid centroids).  The last block
//       to finish (a ticket counter, reset to 0 after) finds each
//       query's exact nprobe-th largest valid score, one warp a query,
//       by a radix select with 8-bit digits on the order-preserving bit
//       pattern (4 histogram passes over keys held in registers), and
//       writes the [B, Nc] admitted
//       mask: every valid cluster scoring at least that (ties at the
//       nprobe-th score admit every tied cluster, as on the TPU; fewer
//       valid than nprobe admits every valid one);
//   (b) the page search and its merge in one grid (page_topk.cuh, which
//       describes it), a page admitted for a query iff (a) admitted the
//       page's cluster.
//
// Layouts: q [B, d] fp32; centroids [Nc, d] fp32; valid [Nc] bool (uint8);
// pages [P, ps, d] bf16; page_ids [P, ps] int32; page_cluster [P] int32
// (-1 = unsearchable slot); scores [B, Nc] fp32 and cand_s / cand_o
// [blocks, B, k] scratch; count: two ints, 0 between launches; outputs
// admitted [B, Nc] uint8, scores [B, k] fp32, ids [B, k] int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "page_topk.cuh"

namespace {

using page_topk::kFull;
using page_topk::kThreads;
using page_topk::kWarps;
constexpr float kFiniteNeg = -1.0e30f;  // invalid-centroid sentinel
constexpr float kValidFloor = -1.0e29f; // scores above this came from a real centroid

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// order-preserving map of a float onto uint32 (larger float, larger key)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr int kKeyRegs = 32;   // keys a lane holds: rows of Nc <= 1024 stay in registers

// The key of the nprobe-th largest valid score of row s [Nc], by one warp:
// four passes of an 8-bit-digit histogram (hist: 256 words of this warp's
// own).  0 when fewer than nprobe scores are valid, which admits them all.
// key[] holds the row's keys (0 = invalid; no valid score maps to 0) when
// `regs`, else each pass reads the row again.
__device__ __forceinline__ unsigned select_key(const float* s, int Nc, int nprobe, bool regs,
                               const unsigned (&key)[kKeyRegs], unsigned* hist, int lane) {
  unsigned prefix = 0, high = 0;   // digits fixed so far, and their bits
  unsigned need = (unsigned)nprobe;
  for (int shift = 24; shift >= 0; shift -= 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) hist[lane * 8 + i] = 0;
    __syncwarp();
    if (regs) {
#pragma unroll
      for (int i = 0; i < kKeyRegs; ++i)
        if (key[i] && (key[i] & high) == prefix) atomicAdd(&hist[(key[i] >> shift) & 255u], 1u);
    } else {
      for (int c = lane; c < Nc; c += 32) {
        const float v = __ldcg(s + c);
        const unsigned kc = order_key(v);
        if (v > kValidFloor && (kc & high) == prefix) atomicAdd(&hist[(kc >> shift) & 255u], 1u);
      }
    }
    __syncwarp();
    unsigned mine[8], sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mine[i] = hist[lane * 8 + i];
      sum += mine[i];
    }
    unsigned suf = sum;   // keys whose digit is in this lane's bins or above
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_down_sync(kFull, suf, o);
      if (lane + o < 32) suf += t;
    }
    if (__shfl_sync(kFull, suf, 0) < need) return 0u;   // only in the first pass
    const unsigned ge = __ballot_sync(kFull, suf >= need);
    const int top = 31 - __clz(ge);   // the lane whose bins hold the digit
    int digit = -1;
    unsigned above = 0, acc = suf - sum;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      if (digit < 0 && acc + mine[i] >= need) {
        digit = lane * 8 + i;
        above = acc;
      }
      acc += mine[i];
    }
    digit = __shfl_sync(kFull, digit, top);
    above = __shfl_sync(kFull, above, top);
    need -= above;
    prefix |= (unsigned)digit << shift;
    high |= 255u << shift;
    __syncwarp();
  }
  return prefix;
}

// (a) masked centroid scores, then (last block) thresholds -> admitted mask
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ q, const float* __restrict__ cent,
             const uint8_t* __restrict__ valid, float* __restrict__ scores,
             uint8_t* __restrict__ admit, int* __restrict__ count, int B, int Nc, int d,
             int nprobe, int vec) {
  __shared__ unsigned hist[kWarps][256];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.x * kWarps + warp;

  if (c < Nc) {
    const bool ok = valid[c] != 0;
    const float* cr = cent + (long long)c * d;
    for (int b = 0; b < B; ++b) {
      float acc = 0.f;
      if (ok) {
        const float* qb = q + (long long)b * d;
        if (vec) {   // d % 4 == 0, rows 16-byte aligned
          const float4* c4 = reinterpret_cast<const float4*>(cr);
          const float4* q4 = reinterpret_cast<const float4*>(qb);
          for (int i = lane; i < d / 4; i += 32) {
            const float4 x = c4[i], y = q4[i];
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
            acc = fmaf(x.z, y.z, acc);
            acc = fmaf(x.w, y.w, acc);
          }
        } else {
          for (int i = lane; i < d; i += 32) acc = fmaf(cr[i], qb[i], acc);
        }
        acc = warp_sum(acc);
      }
      if (lane == 0) scores[(long long)b * Nc + c] = ok ? acc : kFiniteNeg;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const bool regs = Nc <= 32 * kKeyRegs;
  for (int b = warp; b < B; b += kWarps) {
    const float* s = scores + (long long)b * Nc;
    unsigned key[kKeyRegs];
    if (regs) {   // every load of the row at once
#pragma unroll
      for (int i = 0; i < kKeyRegs; ++i) {
        const int ci = lane + 32 * i;
        const float v = __ldcg(s + min(ci, Nc - 1));
        key[i] = ci < Nc && v > kValidFloor ? order_key(v) : 0u;
      }
    }
    const unsigned T = select_key(s, Nc, nprobe, regs, key, hist[warp], lane);
    if (regs) {
#pragma unroll
      for (int i = 0; i < kKeyRegs; ++i) {
        const int ci = lane + 32 * i;
        if (ci < Nc) admit[(long long)b * Nc + ci] = key[i] && key[i] >= T ? 1 : 0;
      }
    } else {
      for (int i = lane; i < Nc; i += 32) {
        const float v = __ldcg(s + i);
        admit[(long long)b * Nc + i] = (v > kValidFloor && order_key(v) >= T) ? 1 : 0;
      }
    }
  }
  if (tid == 0) *count = 0;
}

}  // namespace

// Two grids on `stream`: the probe, then the search and merge.
extern "C" int probe_topk_fused(const float* q, const float* cent, const uint8_t* valid,
                                const void* pages, const int* page_ids,
                                const int* page_cluster, uint8_t* admit, float* scores,
                                float* cand_s, int* cand_o, int* count, float* out_s,
                                int* out_i, int B, int d, int Nc, int P, int ps, int nprobe,
                                int k, int rows, int stages, int pass, int blocks, int vec,
                                void* stream) {
  if (d < 1 || Nc < 1 || ps < 1 || k < 1 || nprobe < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_kernel<<<(Nc + kWarps - 1) / kWarps, kThreads, 0, s>>>(q, cent, valid, scores, admit,
                                                               count + 1, B, Nc, d, nprobe,
                                                               vec);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return page_topk::search(q, pages, page_ids, page_topk::ClusterAdmit{admit, page_cluster, Nc},
                           cand_s, cand_o, count, out_s, out_i, B, P, ps, d, k,
                           page_topk::Plan{rows, stages, pass}, blocks, s);
}
