// Per-page masked search and the top-k merge, shared by the fused
// (probe_topk.cu) and the unfused (ivf_topk.cu) retrieval kernels.  The
// two differ only in how a (query, page) pair is admitted: by the page's
// cluster in a [B, Nc] admitted mask (ClusterAdmit), or by a page mask
// given by the caller (PageMaskAdmit).
//
//   page_search_kernel, one block per pool page: a page no query admits
//     is skipped before its vectors are read; otherwise each warp takes
//     rows (16-byte bf16 loads), dots them against up to kQB queries held
//     in shared memory in fp32, and writes the page's top-k of
//     (score, id) per query to [P, B, k] scratch (ids of -1 excluded);
//   merge_kernel, one block per query: reduces the P * k candidates to
//     the final [B, k].  Candidates are ordered by (score desc, ordinal
//     asc) with ordinal = page * k + rank in the page, which is the flat
//     position order lax.top_k breaks ties in.  Slots no vector fills
//     are (-inf, -1).
//
// Layouts: q [B, d] fp32; pages [P, ps, d] bf16; page_ids [P, ps] int32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace page_topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 8;                  // queries per group in the search
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// query b may search page p iff the page's cluster is admitted for b
// (admit [B, Nc]; page_cluster [P], -1 = unsearchable slot)
struct ClusterAdmit {
  const uint8_t* admit;
  const int* page_cluster;
  int Nc;
  __device__ __forceinline__ bool operator()(int b, int p) const {
    const int c = page_cluster[p];
    return c >= 0 && c < Nc && admit[(long long)b * Nc + c];
  }
};

// query b may search page p iff mask[b * stride + p] is set: a per-query
// [B, P] mask has stride P, one [P] mask shared by every query stride 0
struct PageMaskAdmit {
  const uint8_t* mask;
  int stride;
  __device__ __forceinline__ bool operator()(int b, int p) const {
    return mask[(long long)b * stride + p] != 0;
  }
};

template <class Admit>
__global__ void __launch_bounds__(kThreads)
page_search_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ pages,
                   const int* __restrict__ page_ids, Admit admitted,
                   float* __restrict__ cand_s, int* __restrict__ cand_i, int B, int ps,
                   int d, int k, int vec) {
  extern __shared__ float smem[];
  float* q_s = smem;               // [kQB, d]
  float* s_s = smem + kQB * d;     // [kQB, ps]
  __shared__ int any_s;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long cbase = (long long)p * B * k;

  if (tid == 0) {
    int any = 0;
    for (int b = 0; b < B && !any; ++b) any = admitted(b, p);
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
    for (int t = 0; t < kQB; ++t) adm[t] = t < nb && admitted(b0 + t, p);

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

// one block per query: the final top-k over every page's candidates
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

inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// page search (skipped when there are no pages) then merge, on stream s;
// returns the first CUDA error, 0 on success
template <class Admit>
int search_and_merge(const float* q, const void* pages, const int* page_ids, Admit admitted,
                     float* cand_s, int* cand_i, float* out_s, int* out_i, int B, int P,
                     int ps, int d, int k, int vec, cudaStream_t s) {
  int err;
  if (P > 0) {
    const size_t smem = (size_t)kQB * (d + ps) * sizeof(float);
    if ((err = set_smem((const void*)page_search_kernel<Admit>, smem))) return err;
    page_search_kernel<Admit><<<P, kThreads, smem, s>>>(
        q, static_cast<const __nv_bfloat16*>(pages), page_ids, admitted, cand_s, cand_i, B,
        ps, d, k, vec);
    if ((err = (int)cudaGetLastError())) return err;
  }
  merge_kernel<<<B, kThreads, 0, s>>>(cand_s, cand_i, out_s, out_i, P, B, k);
  return (int)cudaGetLastError();
}

}  // namespace page_topk
