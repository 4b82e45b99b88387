// Single-token GQA decode attention over a paged KV slab, read in place
// through a block table.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_paged
//           (Pallas body _paged_kernel).
//
// Bound on an H100: bytes up to G of about 40 with bf16 q and K/V
// (operations past it, as flash_decode.cu says).  A decode step reads each
// live K/V row once
// (2 * len * Dh * 2 bytes per (b, kv-head)) and does 4 * G * Dh flops per
// row, far below the ~295 flop/byte at which the tensor cores become the
// limit.  So the design reads each live row once, 16 bytes a thread,
// keeps every intermediate on chip, and spreads a row's positions over
// enough blocks to fill the SMs:
//   * one grid of (split, kv-head, b) blocks, each split a whole number of
//     64-position chunks of the MB * ps table positions, with the core and
//     the in-launch combine of the dense kernel (decode_attn.cuh; the
//     dense source's header says why a ticket counter and not a cluster);
//   * a split walks only positions < lengths[b] (and inside the window);
//     one past them returns at once;
//   * each position's row is a gather through the block table, which the
//     block reads itself (no scalar prefetch on this card); the rows are
//     16-byte cp.async copies into shared memory, double buffered, which
//     suits a gather better than TMA's rectangular tiles.
//
// Layouts: q [B, KVH, G, Dh] and k/v pages [NP, ps, KVH, Dh], as bf16/bf16,
// fp32/bf16 or fp32/fp32 (q/kv); block_table [B, MB] int32 (-1 = unused tail, read as
// page 0 like the reference); lengths [B] int32; out [B, KVH, G, Dh] fp32;
// scratch and count as in flash_decode.cu.  Takes G = 1..64 (past 8 in
// tiles, as flash_decode.cu), Dh in {32, 64, 128}, any ps >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

template <typename QT, typename KT, int Dh, int GM>
__global__ void __launch_bounds__(kThreads)
paged_kernel(Args a, const int* __restrict__ block_table, const int* __restrict__ lengths,
             int KVH, int ps, int MB, int window) {
  const int h = kv_head(a.ngt);
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 0), MB * ps);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int* bt = block_table + (long long)b * MB;
  const long long stride = (long long)KVH * Dh;
  const long long head = (long long)h * Dh;
  decode_block<QT, KT, Dh, GM>(a, b * KVH + h, lo, len, [=](int t) {
    return ((long long)max(bt[t / ps], 0) * ps + t % ps) * stride + head;
  });
}

struct Paged {
  const int* bt;
  const int* lengths;
  int KVH, ps, MB, window;
};

template <typename QT, typename KT, int Dh, int GM>
int launch_g(const Args& a, dim3 grid, const Paged& p, cudaStream_t stream) {
  return launch_kernel<paged_kernel<QT, KT, Dh, GM>>(
      smem_bytes<KT, Dh, GM>(), grid, stream, a, p.bt, p.lengths, p.KVH, p.ps, p.MB,
      p.window);
}

template <typename QT, typename KT, int Dh>
int launch_dh(const Args& a, dim3 grid, const Paged& p, cudaStream_t stream) {
  if (a.G <= 1) return launch_g<QT, KT, Dh, 1>(a, grid, p, stream);
  if (a.G <= 2) return launch_g<QT, KT, Dh, 2>(a, grid, p, stream);
  if (a.G <= 4) return launch_g<QT, KT, Dh, 4>(a, grid, p, stream);
  return launch_g<QT, KT, Dh, kMaxG>(a, grid, p, stream);
}

template <typename QT, typename KT>
int launch(const Args& a, int Dh, dim3 grid, const Paged& p, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch_dh<QT, KT, 32>(a, grid, p, stream);
    case 64: return launch_dh<QT, KT, 64>(a, grid, p, stream);
    case 128: return launch_dh<QT, KT, 128>(a, grid, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One grid launch; split and nsplit cover the MB * ps table positions.
extern "C" int flash_decode_paged(const void* q, int q_bf16, const void* k_pages,
                                  const void* v_pages, int kv_bf16, const int* block_table,
                                  const int* lengths, float* out, float* part_m,
                                  float* part_l, float* part_acc, int* count, int B,
                                  int KVH, int G, int Dh, int ps, int MB, int window,
                                  int split, int nsplit, float scale, void* stream) {
  const int ngt = (G + decode_attn::kMaxG - 1) / decode_attn::kMaxG;
  if (G < 1 || G > decode_attn::kMaxRows || ps < 1 || MB < 1 || split < 1 ||
      split % decode_attn::kChunk || nsplit < 1 || (long long)split * nsplit < (long long)MB * ps ||
      (long long)MB * ps > 0x7fffffff || KVH * ngt > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  const decode_attn::Args a{q, k_pages, v_pages, out, part_m, part_l, part_acc, count, G,
                            ngt, split, nsplit, scale};
  const Paged p{block_table, lengths, KVH, ps, MB, window};
  const dim3 grid(nsplit, KVH * ngt, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, Dh, grid, p, s);
  if (q_bf16) return (int)cudaErrorInvalidValue;   // bf16 q over fp32 K/V: no caller
  if (kv_bf16) return launch<float, __nv_bfloat16>(a, Dh, grid, p, s);
  return launch<float, float>(a, Dh, grid, p, s);
}
