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
// splits combined in the same launch) with a splice policy that keeps the
// page tables out of the inner loops:
//   * chunk descriptors in shared memory: warp 0 copies a chunk's table
//     entries (block id, page_valid, page_delta of each of its 64
//     positions) into shared memory with 4-byte cp.async two chunks
//     ahead, so no table read waits in a thread while the block
//     computes, and writes them as one descriptor: each position's row
//     offset and delta, its
//     live bit (t % ps < page_valid[b, t / ps]), and the chunk's mode.
//     Three descriptors rotate (the one in use, the one whose copy is in
//     flight, the one being written), so the copy of chunk c + 1 is issued
//     from shared memory at the top of iteration c.  Chunk 0 is copied
//     straight from the tables, as flash_decode_paged copies, so no
//     barrier comes before the first copy; the policy's few registers
//     hold the chunk in use, the table arguments are read in place from
//     the kernel's parameter space;
//   * a chunk whose every position is live with delta 0 (all its pages
//     fresh) runs the NoSplice code: no liveness test, no rotation.  A
//     chunk with dead positions but no rotated one tests liveness only;
//   * a dead position (a chunk's partial last page, a -1 column with valid
//     0) is never copied, never read, scored -inf and left out of P V.  A
//     split or a chunk with no live position reaches the combine as
//     m = -inf, l = 0, acc = 0, never as a NaN;
//   * one angle table a chunk: the chunk's runs of one nonzero delta get
//     their cos/sin for the rot/2 frequencies computed once, spread over
//     the block's threads, into a double-buffered table (kTab entries; a
//     chunk with more runs than fit, which takes page sizes below ~16,
//     computes each angle where it is used, with the same bits);
//   * rotation partners by register shuffle, in a pass of its own: in a
//     chunk with a rotated row, before the scores, each thread rotates in
//     shared memory the K row slices it then reads, so the score loop is
//     the unspliced one with a liveness test (rotating inside it made the
//     unrolled loop large enough to slow even an all-fresh table).  The
//     rotate-half partner of dim i is i + rot/2 or i - rot/2, which lies
//     in lane sub ^ (rot/2 / V) of the same row when rot/2 is a multiple
//     of V and that distance is a power of two below the row's lane count
//     (the wrapper's plan passes it, 0 otherwise).  Every lane of the warp
//     shuffles its unrotated slice (rows of one warp may differ in delta
//     and liveness), then each live lane rotates and writes its own;
//     without a distance, a lane reads its partners from the staged row,
//     and the warp syncs before anyone writes;
//   * the rotation is the oracle's apply_rope: the angle delta * freq in
//     fp32 from the wrapper's table of the port's rope_frequencies, the
//     accurate sincosf, x1 cos - x2 sin and x2 cos + x1 sin with no fused
//     multiply-add, and the result rounded back to the page dtype before
//     the fp32 dot; delta 0 (a fresh page) leaves K as stored, as the
//     oracle's rotation by 0 does.  So the output bits do not depend on
//     which of these paths a chunk takes.
//
// Layouts: q [B, KVH, G, Dh] and k/v pages [NP, ps, KVH, Dh], as bf16/bf16,
// fp32/bf16 or fp32/fp32 (q/kv); block_table, page_delta, page_valid
// [B, MB] int32; lengths [B] int32 layout positions; freq [rot/2] fp32;
// out [B, KVH, G, Dh] fp32; scratch and count as in flash_decode.cu.
// Takes G = 1..64 (past 8 in tiles, as flash_decode.cu), Dh in {32, 64,
// 128}, any ps >= 1, rot even in [0, Dh].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

constexpr int kTab = 256;   // cos/sin pairs in one chunk's angle table

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Wait for this thread's cp.async groups but the `pending` newest (0-2).
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of a K row back into shared memory (the values already hold
// the row's dtype, so the conversion is exact).
__device__ __forceinline__ void store16(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  unsigned* w = &u.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&t);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// A chunk's description, written by warp 0 before the barrier that
// precedes its copy.
struct ChunkDesc {
  long long off[kChunk];    // slab row (page * ps + slot) of each live position
  int dl[kChunk];           // its page delta (0 for a dead position)
  int rdl[kChunk];          // delta of each angle-table entry (run)
  signed char run[kChunk];  // the run of a rotated position, else -1
  unsigned live[2];         // live bits of positions 0-31 and 32-63
  int mode;                 // kFresh, kMasked or kRotated
  int nruns;                // runs of one nonzero delta
};

constexpr int kFresh = 0;     // every position live, none rotated
constexpr int kMasked = 1;    // some dead, none rotated
constexpr int kRotated = 2;   // some live position rotated

// The table arguments, read in place from the kernel's parameter space
// (__grid_constant__), so the policy holds none of them in registers.
struct SpliceArgs {
  const int* bt;       // [B, MB] block_table
  const int* delta;    // [B, MB] page_delta
  const int* valid;    // [B, MB] page_valid
  const float* freq;   // [rot / 2]
  int KVH, ps, shift, MB, rot;   // shift = log2(ps) for a power of two, else -1
  int ngt;             // G tiles on blockIdx.y
  int dist;            // partner lane distance, 0: partners from shared memory
  int runs_max;        // table entries a chunk may use
  int fresh_path;      // fresh chunks take the NoSplice code
};

// The splice policy of the block's batch row (blockIdx.z) and kv-head
// (blockIdx.y, over the G tiles), for rows of Dh elements: in shared
// memory the descriptors of three chunks, the angle tables of two and the table
// entries warp 0 has in flight; in registers only which chunk is in use,
// its mode and live bits.
template <int Dh>
struct Splice {
  static constexpr bool kOn = true;
  static constexpr int kSmem =
      3 * (int)sizeof(ChunkDesc) + 2 * kTab * (int)sizeof(float2) + 2 * 3 * kChunk * 4;
  const SpliceArgs& p;
  const int h;           // the block's kv-head, kv_head(p.ngt)
  unsigned char* base;   // this policy's shared memory
  int cidx, cmode;       // the chunk in use and its mode
  unsigned clive0, clive1;

  __device__ __forceinline__ Splice(const SpliceArgs& args, int head) : p(args), h(head) {}

  __device__ __forceinline__ ChunkDesc* desc(int ci) const {
    return reinterpret_cast<ChunkDesc*>(base) + ci % 3;
  }
  __device__ __forceinline__ float2* tab(int ci) const {
    return reinterpret_cast<float2*>(base + 3 * sizeof(ChunkDesc)) + (ci & 1) * kTab;
  }
  // chunk ci's table entries in flight, [block id, valid, delta][kChunk]
  // (two buffers: chunks 0 and 1 are fetched together)
  __device__ __forceinline__ int* fetched(int ci) const {
    return reinterpret_cast<int*>(base + 3 * sizeof(ChunkDesc) + 2 * kTab * sizeof(float2)) +
           (ci & 1) * 3 * kChunk;
  }
  __device__ __forceinline__ int page(int t) const { return p.shift >= 0 ? t >> p.shift : t / p.ps; }
  __device__ __forceinline__ int slot(int t) const {
    return p.shift >= 0 ? t & (p.ps - 1) : t - page(t) * p.ps;
  }
  __device__ __forceinline__ int half() const { return p.rot >> 1; }

  __device__ __forceinline__ void bind(unsigned char* s) { base = s; }

  // Warp 0 copies the table entries of chunk ci's positions [c0, c0 + n)
  // into shared memory, as one cp.async group of its own.
  __device__ __forceinline__ void fetch(int ci, int c0, int n) const {
    if (threadIdx.x >= 32) return;
    const long long row = (long long)blockIdx.z * p.MB;
    int* f = fetched(ci);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = threadIdx.x + 32 * h;
      if (j < n) {
        const long long pg = row + page(c0 + j);
        cp_async4(f + j, p.bt + pg);
        cp_async4(f + kChunk + j, p.valid + pg);
        cp_async4(f + 2 * kChunk + j, p.delta + pg);
      }
    }
    cp_async_commit();
  }

  // Warp 0 waits for its fetched entries of positions [c0, c0 + n) (the
  // `pending` cp.async groups it issued after them may stay in flight)
  // and writes them as chunk ci's descriptor: offsets, deltas, live bits,
  // runs of one nonzero delta (a run starts where a rotated position
  // follows a position that is not rotated or has another delta), and the
  // mode.
  __device__ __forceinline__ void store(int ci, int c0, int n, int pending) const {
    if (threadIdx.x >= 32) return;
    cp_async_wait(pending);
    const int lane = threadIdx.x;
    const int* f = fetched(ci);
    ChunkDesc& d = *desc(ci);
    bool lv[2], rt[2];
    int dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const int sl = slot(c0 + j);
      lv[h] = j < n && sl < f[kChunk + j];
      dd[h] = lv[h] ? f[2 * kChunk + j] : 0;
      rt[h] = lv[h] && dd[h] != 0 && p.rot > 0;
      if (lv[h]) d.off[j] = (long long)max(f[j], 0) * p.ps + sl;   // slab row
      d.dl[j] = dd[h];
    }
    // the previous position's rotation and delta (position 31's for 32)
    const int up_rt0 = __shfl_up_sync(0xffffffffu, (int)rt[0], 1);
    const int up_dd0 = __shfl_up_sync(0xffffffffu, dd[0], 1);
    const int up_rt1 = __shfl_up_sync(0xffffffffu, (int)rt[1], 1);
    const int up_dd1 = __shfl_up_sync(0xffffffffu, dd[1], 1);
    const int last_rt0 = __shfl_sync(0xffffffffu, (int)rt[0], 31);
    const int last_dd0 = __shfl_sync(0xffffffffu, dd[0], 31);
    const bool st0 = rt[0] && (lane == 0 || !up_rt0 || up_dd0 != dd[0]);
    const bool st1 = rt[1] && (lane == 0 ? (!last_rt0 || last_dd0 != dd[1])
                                         : (!up_rt1 || up_dd1 != dd[1]));
    const unsigned s0 = __ballot_sync(0xffffffffu, st0);
    const unsigned s1 = __ballot_sync(0xffffffffu, st1);
    const unsigned l0 = __ballot_sync(0xffffffffu, lv[0]);
    const unsigned l1 = __ballot_sync(0xffffffffu, lv[1]);
    const bool any_rt = __any_sync(0xffffffffu, rt[0] || rt[1]);
    const bool all_lv = __all_sync(0xffffffffu, (lane >= n || lv[0]) && (lane + 32 >= n || lv[1]));
    const unsigned upto = 0xffffffffu >> (31 - lane);   // bits 0..lane
    const int r0 = __popc(s0 & upto) - 1;
    const int r1 = __popc(s0) + __popc(s1 & upto) - 1;
    d.run[lane] = rt[0] ? (signed char)r0 : (signed char)-1;
    d.run[lane + 32] = rt[1] ? (signed char)r1 : (signed char)-1;
    if (st0) d.rdl[r0] = dd[0];
    if (st1) d.rdl[r1] = dd[1];
    if (lane == 0) {
      d.live[0] = l0;
      d.live[1] = l1;
      d.nruns = __popc(s0) + __popc(s1);
      d.mode = any_rt ? kRotated : (all_lv && p.fresh_path ? kFresh : kMasked);
    }
    __syncwarp();   // the descriptor is whole for warp 0 (chunk 0's angles)
  }

  // Threads [0, n) fill chunk ci's angle table, if it rotates and its
  // runs fit (the block for a chunk ahead; warp 0 for chunk 0, whose
  // descriptor only it has seen before the first barrier).
  __device__ __forceinline__ void angles(int ci, int n) const {
    if ((int)threadIdx.x >= n) return;
    const ChunkDesc& d = *desc(ci);
    if (d.mode != kRotated || d.nruns > p.runs_max) return;
    float2* t = tab(ci);
    const int hf = half();
    for (int w = threadIdx.x; w < d.nruns * hf; w += n) {
      const int r = w / hf;
      const int i = w - r * hf;
      float sn, cs;
      sincosf(__fmul_rn((float)d.rdl[r], p.freq[i]), &sn, &cs);
      t[w] = make_float2(cs, sn);
    }
  }

  __device__ __forceinline__ void use(int ci) {
    const ChunkDesc& d = *desc(ci);
    cidx = ci;
    cmode = d.mode;
    clive0 = d.live[0];
    clive1 = d.live[1];
  }

  __device__ __forceinline__ bool staged(int ci, int j) const {
    const ChunkDesc& d = *desc(ci);
    return ((j < 32 ? d.live[0] >> j : d.live[1] >> (j - 32)) & 1u) != 0;
  }
  // the element offset of row j of chunk ci in this kv-head
  __device__ __forceinline__ long long offset(int ci, int j) const {
    return (desc(ci)->off[j] * p.KVH + h) * Dh;
  }

  // Whether row j of the chunk in use is live (ok: j < n).
  __device__ __forceinline__ bool live(int j, bool ok) const {
    if (cmode == kFresh) return ok;
    return ((j < 32 ? clive0 >> j : clive1 >> (j - 32)) & 1u) != 0;
  }

  // One rotated element: x1 cos - x2 sin below rot/2 (lo, as x1 cos +
  // -(x2 sin), the same bits), x2 cos + x1 sin above, rounded to the page
  // dtype.
  template <typename KT>
  static __device__ __forceinline__ float turn(float x, float x2, float cs, float sn, bool lo,
                                               const KT* row) {
    const float t = __fmul_rn(x2, sn);
    return round_as(__fadd_rn(__fmul_rn(x, cs), lo ? -t : t), row);
  }

  // Whether the chunk in use has a rotated row (block-uniform).
  __device__ __forceinline__ bool rotating() const { return cmode == kRotated; }

  // Rotate this thread's slice, dims [d0, d0 + V), of the staged K row
  // `row`, row j of the chunk in use, by its page delta, in place.  Every
  // lane of the warp calls it for every row (rows of one warp may differ
  // in delta and liveness): each reads its slice and its partners (by
  // shuffle with lane ^ dist, or from the row), the warp syncs, and only
  // a live lane with rotated dims writes.  With a partner distance the
  // slice lies wholly below rot/2 or wholly in [rot/2, rot), and its
  // cos/sin are V consecutive table pairs, read 16 bytes at a time.
  template <typename KT, int V>
  __device__ __forceinline__ void rotate(KT* row, int d0, int j) const {
    const ChunkDesc& d = *desc(cidx);
    const int dist = p.dist, rot = p.rot, hf = rot >> 1;
    float kf[V], x2[V];
    load16(row + d0, kf);
    if (dist) {
#pragma unroll
      for (int e = 0; e < V; ++e) x2[e] = __shfl_xor_sync(0xffffffffu, kf[e], dist);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = d0 + e;
        x2[e] = i < rot ? to_f(row[i < hf ? i + hf : i - hf]) : 0.f;
      }
    }
    __syncwarp();   // the row is read before any lane writes it
    const int r = d.run[j];
    if (!live(j, true) || r < 0 || d0 >= rot) return;
    const bool table = d.nruns <= p.runs_max;
    const float2* t = tab(cidx) + r * hf;
    if (dist && table) {
      const bool lo = d0 < hf;
      const float4* t4 = reinterpret_cast<const float4*>(t + (lo ? d0 : d0 - hf));
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        const float4 a = t4[e / 2];
        kf[e] = turn(kf[e], x2[e], a.x, a.y, lo, row);
        kf[e + 1] = turn(kf[e + 1], x2[e + 1], a.z, a.w, lo, row);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = d0 + e;
        if (i < rot) {
          const bool lo = i < hf;
          const int f = lo ? i : i - hf;
          float cs, sn;
          if (table) {
            cs = t[f].x;
            sn = t[f].y;
          } else {
            sincosf(__fmul_rn((float)d.dl[j], p.freq[f]), &sn, &cs);
          }
          kf[e] = turn(kf[e], x2[e], cs, sn, lo, row);
        }
      }
    }
    store16(row + d0, kf);
  }

  // Chunk 0 is copied before any barrier, from the tables themselves:
  // whether position t is live, and its row's element offset.
  __device__ __forceinline__ bool direct(int t, long long& off) const {
    const long long pg = (long long)blockIdx.z * p.MB + page(t);
    const int sl = slot(t);
    off = (((long long)max(p.bt[pg], 0) * p.ps + sl) * p.KVH + h) * Dh;
    return sl < p.valid[pg];
  }
};

template <typename QT, typename KT, int Dh, int GM>
__global__ void __launch_bounds__(kThreads)
spliced_kernel(Args a, const int* __restrict__ lengths, const __grid_constant__ SpliceArgs p) {
  const int len = min(max(lengths[blockIdx.z], 0), p.MB * p.ps);
  // rows are staged from the policy's descriptors: the functor is unused
  const int h = kv_head(p.ngt);
  decode_block<QT, KT, Dh, GM>(a, blockIdx.z * p.KVH + h, 0, len,
                               [](int) { return 0LL; }, Splice<Dh>(p, h));
}

template <typename QT, typename KT, int Dh, int GM>
int launch_g(const Args& a, dim3 grid, const int* lengths, const SpliceArgs& p,
             cudaStream_t stream) {
  return launch_kernel<spliced_kernel<QT, KT, Dh, GM>>(
      splice_offset<KT, Dh, GM>() + Splice<Dh>::kSmem, grid, stream, a, lengths, p);
}

template <typename QT, typename KT, int Dh>
int launch_dh(const Args& a, dim3 grid, const int* lengths, const SpliceArgs& p,
              cudaStream_t stream) {
  if (a.G <= 1) return launch_g<QT, KT, Dh, 1>(a, grid, lengths, p, stream);
  if (a.G <= 2) return launch_g<QT, KT, Dh, 2>(a, grid, lengths, p, stream);
  if (a.G <= 4) return launch_g<QT, KT, Dh, 4>(a, grid, lengths, p, stream);
  return launch_g<QT, KT, Dh, kMaxG>(a, grid, lengths, p, stream);
}

template <typename QT, typename KT>
int launch(const Args& a, int Dh, dim3 grid, const int* lengths, const SpliceArgs& p,
           cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch_dh<QT, KT, 32>(a, grid, lengths, p, stream);
    case 64: return launch_dh<QT, KT, 64>(a, grid, lengths, p, stream);
    case 128: return launch_dh<QT, KT, 128>(a, grid, lengths, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Whether dist is a partner distance the kernel can shuffle over: rot/2
// a multiple of the slice width V, dist = rot/2 / V a power of two below
// the lanes of a row (Dh / V).
bool shuffle_ok(int dist, int rot, int Dh, int V) {
  const int half = rot / 2;
  return dist > 0 && (dist & (dist - 1)) == 0 && half == dist * V && dist < Dh / V;
}

}  // namespace

// One grid launch; split and nsplit cover the MB * ps table positions.
// dist, runs_max and fresh_path are the wrapper's plan: the partner lane
// distance (0: partners from shared memory), the runs a chunk's angle
// table may hold (0: every angle computed where it is used, at most
// kTab / (rot/2)), and whether an all-fresh chunk skips the splice code.
extern "C" int flash_decode_spliced(const void* q, int q_bf16, const void* k_pages,
                                    const void* v_pages, int kv_bf16, const int* block_table,
                                    const int* lengths, const int* page_delta,
                                    const int* page_valid, const float* freq, float* out,
                                    float* part_m, float* part_l, float* part_acc, int* count,
                                    int B, int KVH, int G, int Dh, int ps, int MB, int rot,
                                    int dist, int runs_max, int fresh_path, int split,
                                    int nsplit, float scale, void* stream) {
  const int V = kv_bf16 ? 8 : 4;
  const int ngt = (G + decode_attn::kMaxG - 1) / decode_attn::kMaxG;
  if (G < 1 || G > decode_attn::kMaxRows || ps < 1 || MB < 1 || split < 1 ||
      split % decode_attn::kChunk || nsplit < 1 || (long long)split * nsplit < (long long)MB * ps ||
      (long long)MB * ps > 0x7fffffff || KVH * ngt > 65535 || B > 65535 || rot < 0 || rot > Dh ||
      rot % 2 || (dist && !shuffle_ok(dist, rot, Dh, V)) || runs_max < 0 ||
      (long long)runs_max * (rot / 2) > kTab)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  const decode_attn::Args a{q, k_pages, v_pages, out, part_m, part_l, part_acc, count, G,
                            ngt, split, nsplit, scale};
  int shift = -1;   // page and slot by shift and mask when ps is a power of two
  if ((ps & (ps - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < ps) ++shift;
  }
  const SpliceArgs p{block_table, page_delta, page_valid, freq, KVH, ps, shift, MB, rot,
                     ngt, dist, runs_max, fresh_path};
  const dim3 grid(nsplit, KVH * ngt, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, Dh, grid, lengths, p, s);
  if (q_bf16) return (int)cudaErrorInvalidValue;   // bf16 q over fp32 K/V: no caller
  if (kv_bf16) return launch<float, __nv_bfloat16>(a, Dh, grid, lengths, p, s);
  return launch<float, float>(a, Dh, grid, lengths, p, s);
}
