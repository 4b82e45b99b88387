// Fused IVF retrieval over the resident pool pages: centroid probe,
// top-nprobe cluster admission, masked inner product and top-k.
//
// Replaces: src/repro/kernels/probe_topk.py, probe_topk_fused
//           (Pallas body _kernel).
//
// Bound on an H100: bytes.  The work is one pass over the pool pages that
// some query admits (ps * d bf16 values per page, 2 * B flops per value)
// plus the [Nc, d] centroids, far below the ~295 flop/byte at which the
// tensor cores would limit.  Blocks on this card share no scratch without
// a grid-wide sync, so the TPU kernel's one sequential grid becomes three
// launches that keep the semantics:
//   (a) probe_kernel, one block per query: masked centroid scores in
//       shared memory (finite -1e30 sentinel on invalid centroids), the
//       exact nprobe-th largest score by a 32-step radix select on the
//       order-preserving bit pattern, and a [B, Nc] admitted mask
//       (ties at the nprobe-th score admit every tied cluster, as on the
//       TPU);
//   (b) page_search_kernel, one block per pool page, which admits a page
//       for a query iff (a) admitted the page's cluster, and
//   (c) merge_kernel, one block per query: both shared with ivf_topk.cu
//       through page_topk.cuh, which describes them.
// Not done yet (later work): several pages per block with cp.async or TMA
// rings, and a tensor-core product for large query batches.
//
// Layouts: q [B, d] fp32; centroids [Nc, d] fp32; valid [Nc] bool (uint8);
// pages [P, ps, d] bf16; page_ids [P, ps] int32; page_cluster [P] int32
// (-1 = unsearchable slot); outputs scores [B, k] fp32, ids [B, k] int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "page_topk.cuh"

namespace {

using page_topk::kThreads;
using page_topk::kWarps;
using page_topk::warp_sum;
constexpr float kFiniteNeg = -1.0e30f;  // invalid-centroid sentinel
constexpr float kValidFloor = -1.0e29f; // scores above this came from a real centroid

__device__ __forceinline__ unsigned warp_sum_u(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// order-preserving map of a float onto uint32 (larger float, larger key)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (a) masked centroid scores + exact nprobe-th threshold -> admitted mask
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ q, const float* __restrict__ cent,
             const uint8_t* __restrict__ valid, uint8_t* __restrict__ admit, int Nc, int d,
             int nprobe) {
  extern __shared__ float smem[];
  float* q_s = smem;          // [d]
  float* s_s = smem + d;      // [Nc]
  __shared__ unsigned cnt_s[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < d; i += kThreads) q_s[i] = q[(long long)b * d + i];
  __syncthreads();
  for (int c = warp; c < Nc; c += kWarps) {
    const float* cr = cent + (long long)c * d;
    float part = 0.f;
    for (int i = lane; i < d; i += 32) part += q_s[i] * cr[i];
    part = warp_sum(part);
    if (lane == 0) s_s[c] = valid[c] ? part : kFiniteNeg;
  }
  __syncthreads();

  // largest key T with count(valid score >= T) >= nprobe: exactly the
  // nprobe-th largest valid score (T stays 0, admitting every valid
  // cluster, when fewer than nprobe are valid)
  unsigned T = 0u;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = T | (1u << bit);
    unsigned local = 0;
    for (int c = tid; c < Nc; c += kThreads)
      local += (s_s[c] > kValidFloor && order_key(s_s[c]) >= cand) ? 1u : 0u;
    local = warp_sum_u(local);
    if (lane == 0) cnt_s[warp] = local;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += cnt_s[w];
    __syncthreads();
    if (total >= (unsigned)nprobe) T = cand;
  }
  for (int c = tid; c < Nc; c += kThreads)
    admit[(long long)b * Nc + c] = (s_s[c] > kValidFloor && order_key(s_s[c]) >= T) ? 1 : 0;
}

}  // namespace

extern "C" int probe_topk_fused(const float* q, const float* cent, const uint8_t* valid,
                                const void* pages, const int* page_ids,
                                const int* page_cluster, uint8_t* admit, float* cand_s,
                                int* cand_i, float* out_s, int* out_i, int B, int d, int Nc,
                                int P, int ps, int nprobe, int k, int vec, void* stream) {
  if (d < 1 || Nc < 1 || ps < 1 || k < 1 || nprobe < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;

  const size_t smem_a = (size_t)(d + Nc) * sizeof(float);
  if ((err = page_topk::set_smem((const void*)probe_kernel, smem_a))) return err;
  probe_kernel<<<B, kThreads, smem_a, s>>>(q, cent, valid, admit, Nc, d, nprobe);
  if ((err = (int)cudaGetLastError())) return err;

  return page_topk::search_and_merge(q, pages, page_ids,
                                     page_topk::ClusterAdmit{admit, page_cluster, Nc},
                                     cand_s, cand_i, out_s, out_i, B, P, ps, d, k, vec, s);
}
