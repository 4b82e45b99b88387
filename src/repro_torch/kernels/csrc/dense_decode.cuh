// The dense decode kernel and its launch ladder, shared by
// flash_decode.cu (bf16 and fp32 K/V) and flash_decode_quant.cu (int8 K/V
// with per-(position, kv-head) bf16 scales): one block a (split,
// kv-head G tile, b) over positions pos[b] - window < j <= pos[b] of a
// [B, S, KVH, Dh] cache, decode_block doing the work.  The ladder picks
// the instantiation by Dh (32, 64 and 128; 80 for bf16 and fp32 K/V,
// zamba2's heads), the query rows a block holds (1, 2, 4 or 8) and
// whether the scores are softcapped (a.cap > 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_attn.cuh"

namespace dense_decode {

using namespace decode_attn;

template <typename QT, typename KT, int Dh, int GM, bool kCap>
__global__ void __launch_bounds__(kThreads)
dense_kernel(Args a, const int* __restrict__ pos, int S, int KVH, int window) {
  const int h = kv_head(a.ngt);
  const int b = blockIdx.z;
  const int p = pos[b];
  const int hi = min(p + 1, S);
  const int lo = window > 0 ? max(0, p + 1 - window) : 0;
  const long long base = (long long)b * S * KVH * Dh + (long long)h * Dh;
  const long long stride = (long long)KVH * Dh;
  decode_block<QT, KT, Dh, GM, kCap>(a, b * KVH + h, lo, hi,
                                     [=](int t) { return base + t * stride; });
}

template <typename QT, typename KT, int Dh, int GM>
int launch_g(const Args& a, dim3 grid, const int* pos, int S, int KVH, int window,
             cudaStream_t stream) {
  if (a.cap > 0.f)
    return launch_kernel<dense_kernel<QT, KT, Dh, GM, true>>(
        smem_bytes<KT, Dh, GM>(), grid, stream, a, pos, S, KVH, window);
  return launch_kernel<dense_kernel<QT, KT, Dh, GM, false>>(
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
    case 80:
      if constexpr (!std::is_same<KT, int8_t>::value)
        return launch_dh<QT, KT, 80>(a, grid, pos, S, KVH, window, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch's arguments checked as every dense entry point takes them
// (split plan, G, grid limits); 0 when they hold.
inline int check(int B, int S, int KVH, int G, int split, int nsplit) {
  const int ngt = (G + kMaxG - 1) / kMaxG;
  if (G < 1 || G > kMaxRows || S < 1 || split < 1 || split % kChunk || nsplit < 1 ||
      (long long)split * nsplit < S || KVH * ngt > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace dense_decode
