// Single-token GQA decode attention over a dense [B, S, KVH, Dh] KV cache
// with per-row positions: out[b,h,g] = softmax_j(q . k_j / sqrt(Dh)) . v_j
// over pos[b] - window < j <= pos[b] (every j <= pos[b] when window is 0).
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode (Pallas body
//           _kernel).
//
// Bound on an H100: bytes.  A decode step reads each live K/V row once
// (2 * live * Dh * 2 bytes per (b, kv-head) in bf16) and does 4 * G * Dh
// flops per row, far below the ~295 flop/byte at which the tensor cores
// become the limit.  The TPU grid is (B, KVH, S-tiles), run in order with
// the softmax state carried in VMEM across the S tiles; here the S tiles
// are blocks that run in no order, so the state is split:
//   * split_kernel, one block per (kv-head, b, split of `split` positions):
//     the online softmax over the split's live positions only (chunks of
//     decode_attn.cuh, shared with the paged kernel), writing its
//     unnormalised (m, l, acc) to scratch; a split with no live position
//     returns at once, so only live K/V rows are read and S need not be a
//     multiple of any tile;
//   * combine_kernel, one block per (kv-head, b): rescales the live
//     splits' partial states to one maximum and normalises.
// With one split the first kernel normalises and writes the output itself
// and the second is not launched.  The wrapper picks `split` so that
// B * KVH * splits fills the SMs a few times over.
// Not done yet (later work): cp.async/TMA double buffering, and reading
// each V element once for all G rows.
//
// Layouts: q [B, KVH, G, Dh] and k/v [B, S, KVH, Dh], as bf16/bf16,
// fp32/bf16 or fp32/fp32 (q/kv); pos [B] int32; out [B, KVH, G, Dh] fp32;
// scratch [B, KVH, nsplit, G] m and l, [B, KVH, nsplit, G, Dh] acc, fp32.
// Takes G = 1..8, Dh in {32, 64, 128}, any S >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

// Live positions [lo, hi) of a row whose new token is at p.
__device__ __forceinline__ void live_range(int p, int S, int window, int& lo, int& hi) {
  hi = min(p + 1, S);
  lo = window > 0 ? max(0, p + 1 - window) : 0;
}

template <typename QT, typename KT, int VPL>
__global__ void __launch_bounds__(kThreads)
split_kernel(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
             const int* __restrict__ pos, float* __restrict__ out,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int S, int KVH, int G, int window, int split,
             float scale) {
  constexpr int Dh = VPL * 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int nsplit = gridDim.z;
  int lo, hi;
  live_range(pos[b], S, window, lo, hi);
  const int s0 = max(lo, sp * split);
  const int s1 = min(hi, (sp + 1) * split);
  if (nsplit > 1 && s0 >= s1) return;   // combine_kernel reads live splits only

  __shared__ Smem s;
  float acc[kMaxAcc];
  const long long qbase = ((long long)b * KVH + h) * G * Dh;
  init(s, acc, q + qbase, G, Dh);
  for (int c0 = s0; c0 < s1; c0 += kChunk) {
    const int n = min(kChunk, s1 - c0);
    for (int j = threadIdx.x; j < n; j += kThreads)
      s.row[j] = (((long long)b * S + c0 + j) * KVH + h) * Dh;
    attend_chunk<KT, VPL>(s, acc, k, v, n, G, scale);
  }
  if (nsplit == 1) {
    store<Dh>(s, acc, out + qbase, G);
    return;
  }
  const long long part = ((long long)b * KVH + h) * nsplit + sp;
  if (threadIdx.x < G) {
    part_m[part * G + threadIdx.x] = s.m[threadIdx.x];
    part_l[part * G + threadIdx.x] = s.l[threadIdx.x];
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < G * Dh) part_acc[part * G * Dh + e] = acc[i];
  }
}

__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ pos, const float* __restrict__ part_m,
               const float* __restrict__ part_l, const float* __restrict__ part_acc,
               float* __restrict__ out, int S, int KVH, int G, int Dh, int window, int split,
               int nsplit) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int lo, hi;
  live_range(pos[b], S, window, lo, hi);
  const int first = lo / split;
  const int last = hi > lo ? (hi - 1) / split : first - 1;   // no live split: 0 out
  const long long base = ((long long)b * KVH + h) * nsplit;
  for (int e = threadIdx.x; e < G * Dh; e += kThreads) {
    const int g = e / Dh;
    float mx = -INFINITY;
    for (int sp = first; sp <= last; ++sp) mx = fmaxf(mx, part_m[(base + sp) * G + g]);
    float l = 0.f, a = 0.f;
    for (int sp = first; sp <= last; ++sp) {
      const long long i = (base + sp) * G + g;
      const float w = expf(part_m[i] - mx);
      l += part_l[i] * w;
      a += part_acc[i * Dh + e % Dh] * w;
    }
    out[((long long)b * KVH + h) * G * Dh + e] = a / fmaxf(l, 1e-20f);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* pos, float* out,
           float* part_m, float* part_l, float* part_acc, int B, int S, int KVH, int G,
           int Dh, int window, int split, int nsplit, float scale, cudaStream_t stream) {
  const dim3 grid(KVH, B, nsplit);
  const QT* qp = static_cast<const QT*>(q);
  const KT* kp = static_cast<const KT*>(k);
  const KT* vp = static_cast<const KT*>(v);
  switch (Dh) {
    case 32:
      split_kernel<QT, KT, 1><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, pos, out, part_m, part_l, part_acc, S, KVH, G, window, split, scale);
      break;
    case 64:
      split_kernel<QT, KT, 2><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, pos, out, part_m, part_l, part_acc, S, KVH, G, window, split, scale);
      break;
    case 128:
      split_kernel<QT, KT, 4><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, pos, out, part_m, part_l, part_acc, S, KVH, G, window, split, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err || nsplit == 1) return err;
  combine_kernel<<<dim3(KVH, B), kThreads, 0, stream>>>(pos, part_m, part_l, part_acc, out,
                                                        S, KVH, G, Dh, window, split, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// part_m / part_l hold B * KVH * nsplit * G floats and part_acc that times
// Dh; none is read when nsplit is 1.  Positions past S are never read:
// nsplit * split must cover S.
extern "C" int flash_decode(const void* q, int q_bf16, const void* k, const void* v,
                            int kv_bf16, const int* pos, float* out, float* part_m,
                            float* part_l, float* part_acc, int B, int S, int KVH, int G,
                            int Dh, int window, int split, int nsplit, float scale,
                            void* stream) {
  if (G < 1 || G > decode_attn::kMaxG || S < 1 || split < 1 || nsplit < 1 ||
      (long long)split * nsplit < S)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pos, out, part_m, part_l, part_acc,
                                                B, S, KVH, G, Dh, window, split, nsplit,
                                                scale, s);
  if (q_bf16) return (int)cudaErrorInvalidValue;   // bf16 q over fp32 K/V: no caller
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, pos, out, part_m, part_l, part_acc, B, S,
                                        KVH, G, Dh, window, split, nsplit, scale, s);
  return launch<float, float>(q, k, v, pos, out, part_m, part_l, part_acc, B, S, KVH, G, Dh,
                              window, split, nsplit, scale, s);
}
