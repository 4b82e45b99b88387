// Single-token GQA decode attention over a paged KV slab, read in place
// through a block table.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_paged
//           (Pallas body _paged_kernel).
//
// Bound on an H100: bytes.  A decode step reads each live K/V row once
// (2 * len * Dh * 2 bytes per (b, kv-head)) and does 4 * G * Dh flops per
// row, far below the ~295 flop/byte at which the tensor cores become the
// limit.  So the design only has to read each row once and keep every
// intermediate on chip:
//   * one block per (b, kv-head); the G query rows of the group sit in
//     shared memory as fp32 and share every K/V row the block loads;
//   * the block walks only positions < lengths[b] (and inside the
//     window), fetching each position's page through the block table
//     itself (no scalar prefetch on this card);
//   * scores (fp32, scale applied after the dot), the online softmax
//     state (m, l) and the output accumulator never leave the SM;
//   * K rows are read by one warp each, 32 lanes across Dh; V rows by the
//     whole block, consecutive threads on consecutive head dims.
// Not done yet (later work): cp.async/TMA double buffering and a split
// over long contexts to fill more than B * KVH SMs.
//
// Layouts: q [B, KVH, G, Dh] and k/v pages [NP, ps, KVH, Dh], as bf16/bf16,
// fp32/bf16 or fp32/fp32 (q/kv); block_table [B, MB] int32 (-1 = unused tail, read as
// page 0 like the reference); lengths [B] int32; out [B, KVH, G, Dh] fp32.
// Takes G = 1..8, Dh in {32, 64, 128}, any ps >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <typename QT, typename KT, int VPL>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                          const KT* __restrict__ v_pages,
                          const int* __restrict__ block_table,
                          const int* __restrict__ lengths, float* __restrict__ out,
                          int KVH, int G, int ps, int MB, int window, float scale) {
  constexpr int Dh = VPL * 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float q_s[kMaxG][kMaxDh];
  __shared__ float p_s[kMaxG][kChunk];
  __shared__ long long row_s[kChunk];   // element offset of a position's (page, slot, h) row
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float corr_s[kMaxG];

  const long long qbase = ((long long)b * KVH + h) * G * Dh;
  for (int e = tid; e < G * Dh; e += kThreads) q_s[e / Dh][e % Dh] = to_f(q[qbase + e]);
  if (tid < kMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    corr_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > MB * ps ? MB * ps : len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const long long tok_stride = (long long)KVH * Dh;
  __syncthreads();

  for (int c0 = lo; c0 < len; c0 += kChunk) {
    const int n = min(kChunk, len - c0);
    // 1) each position's row through the block table
    for (int j = tid; j < n; j += kThreads) {
      const int pos = c0 + j;
      const int page = max(block_table[(long long)b * MB + pos / ps], 0);
      row_s[j] = ((long long)page * ps + pos % ps) * tok_stride + (long long)h * Dh;
    }
    __syncthreads();

    // 2) scores: one warp per position, lanes across Dh
    for (int j = warp; j < n; j += kWarps) {
      const KT* kr = k_pages + row_s[j] + lane * VPL;
      float kv[VPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) kv[t] = to_f(kr[t]);
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < VPL; ++t) part += q_s[g][lane * VPL + t] * kv[t];
        part = warp_sum(part);
        if (lane == 0) p_s[g][j] = part * scale;
      }
    }
    __syncthreads();

    // 3) online softmax, one warp per query row (every position here is live)
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[g][j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(p_s[g][j] - m_new);
        p_s[g][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // 4) acc = acc * corr + P @ V, consecutive threads on consecutive dims
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * Dh) {
        const int g = e / Dh;
        const int d = e % Dh;
        float a = acc[i] * corr_s[g];
        for (int j = 0; j < n; ++j) a += p_s[g][j] * to_f(v_pages[row_s[j] + d]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * Dh) out[qbase + e] = acc[i] / fmaxf(l_s[e / Dh], 1e-20f);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* bt, const int* lengths,
           float* out, int B, int KVH, int G, int Dh, int ps, int MB, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid(KVH, B);
  const QT* qp = static_cast<const QT*>(q);
  const KT* kp = static_cast<const KT*>(k);
  const KT* vp = static_cast<const KT*>(v);
  switch (Dh) {
    case 32:
      flash_decode_paged_kernel<QT, KT, 1><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, bt, lengths, out, KVH, G, ps, MB, window, scale);
      break;
    case 64:
      flash_decode_paged_kernel<QT, KT, 2><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, bt, lengths, out, KVH, G, ps, MB, window, scale);
      break;
    case 128:
      flash_decode_paged_kernel<QT, KT, 4><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, bt, lengths, out, KVH, G, ps, MB, window, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_paged(const void* q, int q_bf16, const void* k_pages,
                                  const void* v_pages, int kv_bf16, const int* block_table,
                                  const int* lengths, float* out, int B, int KVH, int G,
                                  int Dh, int ps, int MB, int window, float scale,
                                  void* stream) {
  if (G < 1 || G > kMaxG || ps < 1 || MB < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, block_table, lengths,
                                                out, B, KVH, G, Dh, ps, MB, window, scale, s);
  if (q_bf16) return (int)cudaErrorInvalidValue;   // bf16 q over fp32 K/V: no caller
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, block_table, lengths, out, B,
                                        KVH, G, Dh, ps, MB, window, scale, s);
  return launch<float, float>(q, k_pages, v_pages, block_table, lengths, out, B, KVH, G,
                              Dh, ps, MB, window, scale, s);
}
