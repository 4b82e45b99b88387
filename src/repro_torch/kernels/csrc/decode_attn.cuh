// Online-softmax single-token GQA attention over one chunk of cache
// positions, shared by the paged (flash_decode_paged.cu) and the dense
// (flash_decode.cu) decode kernels.  The two differ only in where a
// position's K/V row lives: through a block table into a page slab, or at
// a fixed stride in a [B, S, KVH, Dh] cache.  The caller writes each
// position's row offset into Smem::row and calls attend_chunk.
//
// One block of kThreads serves one (b, kv-head) and its G query rows:
//   * the G query rows sit in shared memory as fp32 and share every K/V
//     row the block loads;
//   * scores (fp32, scale applied after the dot), the online-softmax
//     state (m, l) and the output accumulator never leave the SM;
//   * K rows are read by one warp each, 32 lanes across Dh; V rows by the
//     whole block, consecutive threads on consecutive head dims.
// Takes G = 1..kMaxG and Dh = 32 * VPL with VPL in {1, 2, 4}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxDh = 128;
constexpr int kChunk = 64;                           // positions per softmax step
constexpr int kMaxAcc = kMaxG * kMaxDh / kThreads;   // accumulators per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's shared state.
struct Smem {
  float q[kMaxG][kMaxDh];
  float p[kMaxG][kChunk];
  long long row[kChunk];   // element offset of each chunk position's (token, h) row
  float m[kMaxG];
  float l[kMaxG];
  float corr[kMaxG];
};

// Load the group's query rows q [G, Dh] and clear the softmax state.
template <typename QT>
__device__ __forceinline__ void init(Smem& s, float (&acc)[kMaxAcc], const QT* q, int G,
                                     int Dh) {
  const int tid = threadIdx.x;
  for (int e = tid; e < G * Dh; e += kThreads) s.q[e / Dh][e % Dh] = to_f(q[e]);
  if (tid < kMaxG) {
    s.m[tid] = -INFINITY;
    s.l[tid] = 0.f;
    s.corr[tid] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  __syncthreads();
}

// Fold the n (1..kChunk) positions whose rows the caller wrote into s.row
// into the running softmax.  Every position passed is live.  Returns with
// the block synchronised, so the caller may overwrite s.row.
template <typename KT, int VPL>
__device__ __forceinline__ void attend_chunk(Smem& s, float (&acc)[kMaxAcc],
                                             const KT* __restrict__ k,
                                             const KT* __restrict__ v, int n, int G,
                                             float scale) {
  constexpr int Dh = VPL * 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();

  // 1) scores: one warp per position, lanes across Dh
  for (int j = warp; j < n; j += kWarps) {
    const KT* kr = k + s.row[j] + lane * VPL;
    float kv[VPL];
#pragma unroll
    for (int t = 0; t < VPL; ++t) kv[t] = to_f(kr[t]);
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < VPL; ++t) part += s.q[g][lane * VPL + t] * kv[t];
      part = warp_sum(part);
      if (lane == 0) s.p[g][j] = part * scale;
    }
  }
  __syncthreads();

  // 2) online softmax, one warp per query row
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s.p[g][j]);
    mx = warp_max(mx);
    const float m_prev = s.m[g];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(s.p[g][j] - m_new);
      s.p[g][j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
      s.l[g] = s.l[g] * corr + sum;
      s.m[g] = m_new;
      s.corr[g] = corr;
    }
  }
  __syncthreads();

  // 3) acc = acc * corr + P @ V, consecutive threads on consecutive dims
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * Dh) {
      const int g = e / Dh;
      const int d = e % Dh;
      float a = acc[i] * s.corr[g];
      for (int j = 0; j < n; ++j) a += s.p[g][j] * to_f(v[s.row[j] + d]);
      acc[i] = a;
    }
  }
  __syncthreads();
}

// out [G, Dh] = acc / l (0 where no position was live).
template <int Dh>
__device__ __forceinline__ void store(const Smem& s, const float (&acc)[kMaxAcc], float* out,
                                      int G) {
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < G * Dh) out[e] = acc[i] / fmaxf(s.l[e / Dh], 1e-20f);
  }
}

}  // namespace decode_attn
