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
//   * one block per (b, kv-head), the online softmax over chunks of
//     positions shared with the dense kernel (decode_attn.cuh);
//   * the block walks only positions < lengths[b] (and inside the
//     window), fetching each position's page through the block table
//     itself (no scalar prefetch on this card).
// Not done yet (later work): cp.async/TMA double buffering and a split
// over long contexts to fill more than B * KVH SMs.
//
// Layouts: q [B, KVH, G, Dh] and k/v pages [NP, ps, KVH, Dh], as bf16/bf16,
// fp32/bf16 or fp32/fp32 (q/kv); block_table [B, MB] int32 (-1 = unused tail, read as
// page 0 like the reference); lengths [B] int32; out [B, KVH, G, Dh] fp32.
// Takes G = 1..8, Dh in {32, 64, 128}, any ps >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

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
  __shared__ Smem s;
  float acc[kMaxAcc];
  const long long qbase = ((long long)b * KVH + h) * G * Dh;
  init(s, acc, q + qbase, G, Dh);

  int len = lengths[b];
  len = len < 0 ? 0 : (len > MB * ps ? MB * ps : len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const long long tok_stride = (long long)KVH * Dh;
  for (int c0 = lo; c0 < len; c0 += kChunk) {
    const int n = min(kChunk, len - c0);
    // each position's row through the block table
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int pos = c0 + j;
      const int page = max(block_table[(long long)b * MB + pos / ps], 0);
      s.row[j] = ((long long)page * ps + pos % ps) * tok_stride + (long long)h * Dh;
    }
    attend_chunk<KT, VPL>(s, acc, k_pages, v_pages, n, G, scale);
  }
  store<Dh>(s, acc, out + qbase, G);
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
  if (G < 1 || G > decode_attn::kMaxG || ps < 1 || MB < 1) return (int)cudaErrorInvalidValue;
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
