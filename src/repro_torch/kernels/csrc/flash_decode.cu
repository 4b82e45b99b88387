// Single-token GQA decode attention over a dense [B, S, KVH, Dh] KV cache
// with per-row positions: out[b,h,g] = softmax_j(q . k_j / sqrt(Dh)) . v_j
// over pos[b] - window < j <= pos[b] (every j <= pos[b] when window is 0).
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode (Pallas body
//           _kernel).
//
// Bound on an H100: bytes up to G of about 40 with bf16 q and K/V,
// operations past it: q . K on two bf16 operands counts at the tensor
// cores' rate, P . V (fp32 probabilities) at the fp32 rate, which at
// granite-20b's G = 48 takes 1.2x the bytes' time.  The products run on
// CUDA cores here (a tensor-core design is later work).  A decode step
// reads each live K/V row once
// (2 * live * Dh * 2 bytes per (b, kv-head) in bf16) and does 4 * G * Dh
// flops per row, far below the ~295 flop/byte at which the tensor cores
// become the limit, so the design reads each live row once, 16 bytes a
// thread, and keeps every intermediate on chip (decode_attn.cuh, shared
// with the paged kernel).  The TPU grid walks S tiles in order with the
// softmax state in VMEM; here the S splits are blocks that run in no
// order, one grid of (split, kv-head, b) blocks, enough for several per SM.
// The splits of a (b, kv-head) combine in the same launch: the last live
// split to finish, found by a ticket counter in global memory, rescales
// the others' partial states.  A thread-block cluster reducing through
// distributed shared memory was the other choice; it was not taken
// because a cluster holds at most 8 blocks portably (16 non-portably)
// while a long row wants 16 or more splits, and because every block of a
// cluster would have to wait at its barrier, where an empty split here
// returns at once.
//
// Layouts: q [B, KVH, G, Dh] and k/v [B, S, KVH, Dh], as bf16/bf16,
// fp32/bf16 or fp32/fp32 (q/kv); pos [B] int32; out [B, KVH, G, Dh] fp32;
// scratch [B, KVH, nsplit, G] m and l, [B, KVH, nsplit, G, Dh] acc, fp32;
// count [B, KVH, ngt] int32 (ngt = ceil(G / 8) G tiles), zero before the
// first launch (each launch leaves it zero).  Takes G = 1..64 (past 8 in
// tiles of 8 query rows, a block each, decode_attn.cuh), Dh in {32, 64,
// 128}, any S >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

template <typename QT, typename KT, int Dh, int GM>
__global__ void __launch_bounds__(kThreads)
dense_kernel(Args a, const int* __restrict__ pos, int S, int KVH, int window) {
  const int h = kv_head(a.ngt);
  const int b = blockIdx.z;
  const int p = pos[b];
  const int hi = min(p + 1, S);
  const int lo = window > 0 ? max(0, p + 1 - window) : 0;
  const long long base = (long long)b * S * KVH * Dh + (long long)h * Dh;
  const long long stride = (long long)KVH * Dh;
  decode_block<QT, KT, Dh, GM>(a, b * KVH + h, lo, hi,
                               [=](int t) { return base + t * stride; });
}

template <typename QT, typename KT, int Dh, int GM>
int launch_g(const Args& a, dim3 grid, const int* pos, int S, int KVH, int window,
             cudaStream_t stream) {
  return launch_kernel<dense_kernel<QT, KT, Dh, GM>>(
      smem_bytes<KT, Dh, GM>(), grid, stream, a, pos, S, KVH, window);
}

template <typename QT, typename KT, int Dh>
int launch_dh(const Args& a, dim3 grid, const int* pos, int S, int KVH, int window,
              cudaStream_t stream) {
  if (a.G <= 1) return launch_g<QT, KT, Dh, 1>(a, grid, pos, S, KVH, window, stream);
  if (a.G <= 2) return launch_g<QT, KT, Dh, 2>(a, grid, pos, S, KVH, window, stream);
  if (a.G <= 4) return launch_g<QT, KT, Dh, 4>(a, grid, pos, S, KVH, window, stream);
  return launch_g<QT, KT, Dh, kMaxG>(a, grid, pos, S, KVH, window, stream);
}

template <typename QT, typename KT>
int launch(const Args& a, int Dh, dim3 grid, const int* pos, int S, int KVH, int window,
           cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch_dh<QT, KT, 32>(a, grid, pos, S, KVH, window, stream);
    case 64: return launch_dh<QT, KT, 64>(a, grid, pos, S, KVH, window, stream);
    case 128: return launch_dh<QT, KT, 128>(a, grid, pos, S, KVH, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One grid launch.  part_m / part_l hold B * KVH * nsplit * G floats and
// part_acc that times Dh; none is read by a row with one live split.
// Positions past S are never read: nsplit * split must cover S.
extern "C" int flash_decode(const void* q, int q_bf16, const void* k, const void* v,
                            int kv_bf16, const int* pos, float* out, float* part_m,
                            float* part_l, float* part_acc, int* count, int B, int S,
                            int KVH, int G, int Dh, int window, int split, int nsplit,
                            float scale, void* stream) {
  const int ngt = (G + decode_attn::kMaxG - 1) / decode_attn::kMaxG;
  if (G < 1 || G > decode_attn::kMaxRows || S < 1 || split < 1 ||
      split % decode_attn::kChunk || nsplit < 1 || (long long)split * nsplit < S ||
      KVH * ngt > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  const decode_attn::Args a{q, k, v, out, part_m, part_l, part_acc, count, G, ngt, split,
                            nsplit, scale};
  const dim3 grid(nsplit, KVH * ngt, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, Dh, grid, pos, S, KVH,
                                                                     window, s);
  if (q_bf16) return (int)cudaErrorInvalidValue;   // bf16 q over fp32 K/V: no caller
  if (kv_bf16) return launch<float, __nv_bfloat16>(a, Dh, grid, pos, S, KVH, window, s);
  return launch<float, float>(a, Dh, grid, pos, S, KVH, window, s);
}
