// Single-token GQA decode attention over a paged KV slab whose block table
// mixes fresh pages with spliced chunk-KV pages (TurboRAG reordered RoPE),
// read in place.
//
// Replaces no TPU kernel.  The reference has no Pallas kernel for this
// function: every mode of its kernels/ops.py flash_decode_spliced runs the
// jnp oracle kernels/ref.py flash_decode_spliced_ref.  It was added so
// that the chunk-KV serve path (transformer.serve_step_paged_spliced)
// attends on the card through a hand-written kernel, as the plain paged
// path does through flash_decode_paged.cu.
//
// Bound on an H100: bytes, as flash_decode_paged.cu (the rotation adds
// about 6 flops per rotated K element, far below the ~295 flop/byte line).
// The design is that kernel's (decode_attn.cuh: one grid of (split,
// kv-head, b) blocks, 64-position chunks staged with 16-byte cp.async,
// splits combined in the same launch) with a splice policy:
//   * a position t is live when t % ps < page_valid[b, t / ps]; a dead
//     position (a chunk's partial last page, a -1 column with valid 0) is
//     never copied, never read, scored -inf and left out of P V.  A split
//     or a chunk with no live position reaches the combine as m = -inf,
//     l = 0, acc = 0, never as a NaN;
//   * a live K row slice is rotated by its page's page_delta on its read
//     from shared memory, after the whole row is staged (a rotate-half pair
//     is dims i and i + rot/2, which lie in other threads' copies).  The
//     rotation is the oracle's apply_rope: the angle delta * freq in fp32
//     from the wrapper's table of the port's rope_frequencies, the
//     accurate sincosf, x1 cos - x2 sin and x2 cos + x1 sin with no fused
//     multiply-add, and the result rounded back to the page dtype before
//     the fp32 dot; delta 0 (a fresh page) leaves K as stored, as the
//     oracle's rotation by 0 does.  A thread keeps the cos/sin of its dims
//     for the last delta it saw: a chunk's pages share one delta;
//   * a row's liveness is computed once a chunk and reused by P V; page
//     and slot come by shift and mask when ps is a power of two (the
//     serve's 16), by division otherwise.
//
// Layouts: q [B, KVH, G, Dh] and k/v pages [NP, ps, KVH, Dh], as bf16/bf16,
// fp32/bf16 or fp32/fp32 (q/kv); block_table, page_delta, page_valid
// [B, MB] int32; lengths [B] int32 layout positions; freq [rot/2] fp32;
// out [B, KVH, G, Dh] fp32; scratch and count as in flash_decode.cu.
// Takes G = 1..8, Dh in {32, 64, 128}, any ps >= 1, rot even in [0, Dh].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The splice policy of one batch row: its page_delta and page_valid rows.
struct Splice {
  static constexpr bool kOn = true;
  static constexpr int kMaxV = 8;   // elements of a 16-byte slice
  const int* delta;                 // [MB]
  const int* valid;                 // [MB]
  const float* freq;                // [rot / 2]
  int ps, shift, rot;               // shift = log2(ps) for a power of two, else -1
  int cached = 0;                   // delta whose cos/sin are in c, s
  float c[kMaxV], s[kMaxV];

  // position t's table column and its slot on that page
  __device__ __forceinline__ int page(int t) const { return shift >= 0 ? t >> shift : t / ps; }
  __device__ __forceinline__ int slot(int t) const {
    return shift >= 0 ? t & (ps - 1) : t - page(t) * ps;
  }
  __device__ __forceinline__ bool live(int t) const { return slot(t) < valid[page(t)]; }

  // Rotate this thread's slice kf = dims [d0, d0 + V) of the staged K row
  // `row` (shared memory) by position t's page delta.
  template <typename KT, int V>
  __device__ __forceinline__ void rotate(const KT* row, int d0, int t, float (&kf)[V]) {
    const int dl = delta[page(t)];
    if (dl == 0 || d0 >= rot) return;
    const int half = rot >> 1;
    if (dl != cached) {
      cached = dl;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = d0 + e;
        if (i < rot) sincosf(__fmul_rn((float)dl, freq[i < half ? i : i - half]), &s[e], &c[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = d0 + e;
      if (i < rot) {
        const float x = kf[e];
        const float y = to_f(row[i < half ? i + half : i - half]);
        const float r = i < half ? __fsub_rn(__fmul_rn(x, c[e]), __fmul_rn(y, s[e]))
                                 : __fadd_rn(__fmul_rn(x, c[e]), __fmul_rn(y, s[e]));
        kf[e] = round_as(r, row);
      }
    }
  }
};

template <typename QT, typename KT, int Dh, int GM>
__global__ void __launch_bounds__(kThreads)
spliced_kernel(Args a, const int* __restrict__ block_table, const int* __restrict__ lengths,
               const int* __restrict__ page_delta, const int* __restrict__ page_valid,
               const float* __restrict__ freq, int KVH, int ps, int shift, int MB, int rot) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 0), MB * ps);
  const int* bt = block_table + (long long)b * MB;
  const long long stride = (long long)KVH * Dh;
  const long long head = (long long)h * Dh;
  Splice sp;
  sp.delta = page_delta + (long long)b * MB;
  sp.valid = page_valid + (long long)b * MB;
  sp.freq = freq;
  sp.ps = ps;
  sp.shift = shift;
  sp.rot = rot;
  decode_block<QT, KT, Dh, GM>(
      a, b * KVH + h, 0, len,
      [=](int t) { return ((long long)max(bt[sp.page(t)], 0) * ps + sp.slot(t)) * stride + head; },
      sp);
}

struct Tables {
  const int *bt, *lengths, *delta, *valid;
  const float* freq;
  int KVH, ps, shift, MB, rot;
};

template <typename QT, typename KT, int Dh, int GM>
int launch_g(const Args& a, dim3 grid, const Tables& p, cudaStream_t stream) {
  return launch_kernel<spliced_kernel<QT, KT, Dh, GM>>(smem_bytes<KT, Dh, GM>(), grid, stream,
                                                        a, p.bt, p.lengths, p.delta, p.valid,
                                                        p.freq, p.KVH, p.ps, p.shift, p.MB,
                                                        p.rot);
}

template <typename QT, typename KT, int Dh>
int launch_dh(const Args& a, dim3 grid, const Tables& p, cudaStream_t stream) {
  if (a.G <= 1) return launch_g<QT, KT, Dh, 1>(a, grid, p, stream);
  if (a.G <= 2) return launch_g<QT, KT, Dh, 2>(a, grid, p, stream);
  if (a.G <= 4) return launch_g<QT, KT, Dh, 4>(a, grid, p, stream);
  return launch_g<QT, KT, Dh, 8>(a, grid, p, stream);
}

template <typename QT, typename KT>
int launch(const Args& a, int Dh, dim3 grid, const Tables& p, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch_dh<QT, KT, 32>(a, grid, p, stream);
    case 64: return launch_dh<QT, KT, 64>(a, grid, p, stream);
    case 128: return launch_dh<QT, KT, 128>(a, grid, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One grid launch; split and nsplit cover the MB * ps table positions.
extern "C" int flash_decode_spliced(const void* q, int q_bf16, const void* k_pages,
                                    const void* v_pages, int kv_bf16, const int* block_table,
                                    const int* lengths, const int* page_delta,
                                    const int* page_valid, const float* freq, float* out,
                                    float* part_m, float* part_l, float* part_acc, int* count,
                                    int B, int KVH, int G, int Dh, int ps, int MB, int rot,
                                    int split, int nsplit, float scale, void* stream) {
  if (G < 1 || G > decode_attn::kMaxG || ps < 1 || MB < 1 || split < 1 ||
      split % decode_attn::kChunk || nsplit < 1 || (long long)split * nsplit < (long long)MB * ps ||
      (long long)MB * ps > 0x7fffffff || KVH > 65535 || B > 65535 || rot < 0 || rot > Dh ||
      rot % 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  const decode_attn::Args a{q, k_pages, v_pages, out, part_m, part_l, part_acc, count, G,
                            split, nsplit, scale};
  int shift = -1;   // page and slot by shift and mask when ps is a power of two
  if ((ps & (ps - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < ps) ++shift;
  }
  const Tables p{block_table, lengths, page_delta, page_valid, freq, KVH, ps, shift, MB, rot};
  const dim3 grid(nsplit, KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, Dh, grid, p, s);
  if (q_bf16) return (int)cudaErrorInvalidValue;   // bf16 q over fp32 K/V: no caller
  if (kv_bf16) return launch<float, __nv_bfloat16>(a, Dh, grid, p, s);
  return launch<float, float>(a, Dh, grid, p, s);
}
