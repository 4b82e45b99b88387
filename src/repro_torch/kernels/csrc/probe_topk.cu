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
//   (b) search_kernel, one block per pool page: a page no query admits
//       is skipped before its vectors are read; otherwise each warp takes
//       rows (16-byte bf16 loads), dots them against up to 8 queries held
//       in shared memory in fp32, and writes the page's top-k of
//       (score, id) per query to [P, B, k] scratch (ids of -1 excluded);
//   (c) merge_kernel, one block per query: reduces the P * k candidates
//       to the final [B, k].  Candidates are ordered by (score desc, flat
//       position asc), which is also the order lax.top_k breaks ties in.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 8;                  // queries per group in the search
constexpr float kFiniteNeg = -1.0e30f;  // invalid-centroid sentinel
constexpr float kValidFloor = -1.0e29f; // scores above this came from a real centroid
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// (s, o) comes strictly after (ps, po) in the order (score desc, ordinal asc)
__device__ __forceinline__ bool after(float s, int o, float ps, int po) {
  return s < ps || (s == ps && o > po);
}

// (s, o) ranks before (bs, bo)
__device__ __forceinline__ bool better(float s, int o, float bs, int bo) {
  return s > bs || (s == bs && o < bo);
}

__device__ __forceinline__ void warp_best(float& s, int& o) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const int o2 = __shfl_xor_sync(0xffffffffu, o, off);
    if (better(s2, o2, s, o)) {
      s = s2;
      o = o2;
    }
  }
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

// (b) one block per pool page: masked scores and the page's top-k per query
__global__ void __launch_bounds__(kThreads)
search_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ pages,
              const int* __restrict__ page_ids, const int* __restrict__ page_cluster,
              const uint8_t* __restrict__ admit, float* __restrict__ cand_s,
              int* __restrict__ cand_i, int B, int Nc, int ps, int d, int k, int vec) {
  extern __shared__ float smem[];
  float* q_s = smem;               // [kQB, d]
  float* s_s = smem + kQB * d;     // [kQB, ps]
  __shared__ int any_s;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pc = page_cluster[p];
  const long long cbase = (long long)p * B * k;

  if (tid == 0) {
    int any = 0;
    if (pc >= 0 && pc < Nc)
      for (int b = 0; b < B && !any; ++b) any = admit[(long long)b * Nc + pc];
    any_s = any;
  }
  __syncthreads();
  if (!any_s) {                     // skipped before a vector is read
    for (int e = tid; e < B * k; e += kThreads) {
      cand_s[cbase + e] = -INFINITY;
      cand_i[cbase + e] = -1;
    }
    return;
  }

  const __nv_bfloat16* page = pages + (long long)p * ps * d;
  const int* ids = page_ids + (long long)p * ps;
  for (int b0 = 0; b0 < B; b0 += kQB) {
    const int nb = min(kQB, B - b0);
    for (int e = tid; e < nb * d; e += kThreads) q_s[e] = q[(long long)b0 * d + e];
    __syncthreads();

    bool adm[kQB];
#pragma unroll
    for (int t = 0; t < kQB; ++t) adm[t] = t < nb && admit[(long long)(b0 + t) * Nc + pc];

    for (int r = warp; r < ps; r += kWarps) {
      const __nv_bfloat16* row = page + (long long)r * d;
      float acc[kQB];
#pragma unroll
      for (int t = 0; t < kQB; ++t) acc[t] = 0.f;
      if (vec) {                    // d % 8 == 0 and 16-byte aligned rows
        const uint4* row4 = reinterpret_cast<const uint4*>(row);
        for (int i4 = lane; i4 < d / 8; i4 += 32) {
          const uint4 raw = row4[i4];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float x[8];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 f = __bfloat1622float2(h2[t]);
            x[2 * t] = f.x;
            x[2 * t + 1] = f.y;
          }
          const int base = i4 * 8;
#pragma unroll
          for (int t = 0; t < kQB; ++t) {
            if (t < nb) {
              const float* qr = q_s + t * d + base;
              float a = 0.f;
#pragma unroll
              for (int u = 0; u < 8; ++u) a += qr[u] * x[u];
              acc[t] += a;
            }
          }
        }
      } else {
        for (int i = lane; i < d; i += 32) {
          const float x = __bfloat162float(row[i]);
#pragma unroll
          for (int t = 0; t < kQB; ++t)
            if (t < nb) acc[t] += q_s[t * d + i] * x;
        }
      }
      const bool live = ids[r] >= 0;
#pragma unroll
      for (int t = 0; t < kQB; ++t) {
        if (t < nb) {
          const float s = warp_sum(acc[t]);
          if (lane == 0) s_s[t * ps + r] = (live && adm[t]) ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    // the page's top-k per query: one warp per query, k arg-max rounds
    for (int t = warp; t < nb; t += kWarps) {
      float prev_s = INFINITY;
      int prev_r = -1;
      for (int j = 0; j < k; ++j) {
        float best = -INFINITY;
        int br = kNone;
        for (int r = lane; r < ps; r += 32) {
          const float s = s_s[t * ps + r];
          if (after(s, r, prev_s, prev_r) && better(s, r, best, br)) {
            best = s;
            br = r;
          }
        }
        warp_best(best, br);
        if (lane == 0) {
          const long long o = cbase + (long long)(b0 + t) * k + j;
          const bool found = br != kNone && best != -INFINITY;
          cand_s[o] = found ? best : -INFINITY;
          cand_i[o] = found ? ids[br] : -1;
        }
        prev_s = best;
        prev_r = br;
      }
    }
    __syncthreads();
  }
}

// (c) one block per query: the final top-k over every page's candidates
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
             float* __restrict__ out_s, int* __restrict__ out_i, int P, int B, int k) {
  __shared__ float bs_s[kWarps];
  __shared__ int bo_s[kWarps];
  __shared__ float win_s;
  __shared__ int win_o;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = P * k;              // candidate ordinal o = page * k + j
  float prev_s = INFINITY;
  int prev_o = -1;
  for (int j = 0; j < k; ++j) {
    float best = -INFINITY;
    int bo = kNone;
    for (int o = tid; o < n; o += kThreads) {
      const float s = cand_s[((long long)(o / k) * B + b) * k + o % k];
      if (after(s, o, prev_s, prev_o) && better(s, o, best, bo)) {
        best = s;
        bo = o;
      }
    }
    warp_best(best, bo);
    if (lane == 0) {
      bs_s[warp] = best;
      bo_s[warp] = bo;
    }
    __syncthreads();
    if (tid == 0) {
      float s = bs_s[0];
      int o = bo_s[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(bs_s[w], bo_s[w], s, o)) {
          s = bs_s[w];
          o = bo_s[w];
        }
      const bool found = o != kNone && s != -INFINITY;
      out_s[(long long)b * k + j] = found ? s : -INFINITY;
      out_i[(long long)b * k + j] = found ? cand_i[((long long)(o / k) * B + b) * k + o % k] : -1;
      win_s = s;
      win_o = o;
    }
    __syncthreads();
    prev_s = win_s;
    prev_o = win_o;
    __syncthreads();
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
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
  if ((err = set_smem((const void*)probe_kernel, smem_a))) return err;
  probe_kernel<<<B, kThreads, smem_a, s>>>(q, cent, valid, admit, Nc, d, nprobe);
  if ((err = (int)cudaGetLastError())) return err;

  if (P > 0) {
    const size_t smem_b = (size_t)kQB * (d + ps) * sizeof(float);
    if ((err = set_smem((const void*)search_kernel, smem_b))) return err;
    search_kernel<<<P, kThreads, smem_b, s>>>(
        q, static_cast<const __nv_bfloat16*>(pages), page_ids, page_cluster, admit, cand_s,
        cand_i, B, Nc, ps, d, k, vec);
    if ((err = (int)cudaGetLastError())) return err;
  }

  merge_kernel<<<B, kThreads, 0, s>>>(cand_s, cand_i, out_s, out_i, P, B, k);
  return (int)cudaGetLastError();
}
