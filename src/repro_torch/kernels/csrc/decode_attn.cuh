// Single-token GQA decode attention for one (b, kv-head) and one split of
// its cache positions, shared by the paged (flash_decode_paged.cu), the
// spliced (flash_decode_spliced.cu) and the dense (flash_decode.cu)
// decode kernels.  They differ in where a position's K/V row lives:
// through a block table into a page slab, or at a fixed stride in a
// [B, S, KVH, Dh] cache.  Each kernel computes its positions [lo, hi)
// and hands decode_block a functor from position to the element offset
// of that position's row.  The spliced kernel also hands it a splice
// policy (kOn = true): a position may be dead (never copied, scored
// -inf, left out of P V), and a live row's K is rotated in shared memory
// before the scores.  Such a policy describes each chunk in shared
// memory of its own, two chunks ahead of the scores (pol.fetch issues
// the table reads as cp.async copies, one group ahead of the K/V copy in
// flight; pol.store waits for them and writes the descriptors;
// pol.angles fills a chunk's angle table; pol.use selects the chunk of
// the score loop), and stages rows from its descriptors; the other two
// kernels pass NoSplice, which compiles to the same code as before the
// policy existed.
//
// One grid a call: blockIdx.x is the split (whole kChunk-position chunks,
// `split` positions each), blockIdx.y the kv-head (times the G tiles,
// below), blockIdx.z the batch row.  A block of kThreads serves the G
// query rows of its (b, kv-head):
//   * a split with no live position returns at once (split 0 writes the
//     zero output of a row with none);
//   * K/V rows are copied chunk by chunk into shared memory with 16-byte
//     cp.async, consecutive threads on consecutive addresses, double
//     buffered: the next chunk's copy is in flight while this one computes;
//   * each thread keeps 16 bytes' worth of head dims of every query row
//     in registers, so one K or V row read from shared memory serves all
//     G rows; scores are fp32, the scale applied after the dot;
//   * every warp folds a chunk's scores into its own copy of the softmax
//     state (m, l) (the same arithmetic in every warp, so the copies are
//     equal), which saves a barrier a chunk; the fp32 accumulator stays
//     in registers, one partial per row slot, summed once at the end;
//   * splits of one (b, kv-head) combine in the same launch: each live
//     split writes its unnormalised (m, l, acc) to scratch, fences, and
//     takes a ticket from a per-(b, kv-head) counter; the block that
//     takes the last ticket rescales the splits to one maximum (in split
//     order, so the result does not depend on which block came last),
//     writes the output and resets the counter to 0 for the next launch.
//     A row with one live split writes its output directly.
// Takes G = 1..kMaxRows query rows in ngt = ceil(G / kMaxG) tiles:
// blockIdx.y is kv-head * ngt + tile, each tile a block of its own over
// at most kMaxG query rows (compiled for 1, 2, 4 and 8), which reads the
// (b, kv-head)'s K/V rows once for its rows; the tiles' splits combine apart, each under its own counter, in
// the scratch of the G rows.  Dh in {32, 64, 80, 128}; K/V in bf16 or fp32;
// rows 16-byte aligned.  Dh = 80 (zamba2's heads, the dense kernel in bf16
// and fp32 only) is staged as 80-element rows, but in registers a row
// spreads over the next power of two of lanes (16 for bf16, 32 for fp32):
// the lanes past Dh / kVec hold zeros and read nothing, so the butterflies
// and the row-slot sums stay over a power of two of lanes and add exact
// zeros.  At a power-of-two Dh there are no such lanes and the code is
// what it was.
//
// Two options, each a compile-time flag so that a kernel without it
// compiles to the code it had before: kCap caps every scaled fp32 score
// at a.cap * tanh(s / a.cap) before the mask and the running max (gemma2's
// attention softcap); K/V of type int8_t (the dense kernel's quantized
// cache) carry a bf16 scale per (position, kv-head) at a.k_scale /
// a.v_scale, at the row's element offset over Dh.  An int8 row is staged
// at one byte an element with the same 16-byte cp.async copies and
// dequantized as it is read from shared memory: the fp32 product of the
// value and its scale, rounded to bf16 (the reference's
// dequantize_heads; load16 below does it without a conversion a value),
// then used as a bf16 row is.  The chunk's scales are
// loaded into registers while the chunk before computes and land in
// shared memory before the barrier that opens their chunk.  An int8 block
// also does less of the rest, with the other kernels' values by their
// operations, in their order: the softmax step a query row a warp (not
// every row in every warp, at the cost of a barrier), the softcap there, a
// position a lane (not a row's first lane, row after row), the
// probabilities once into shared memory for P V (not again a row and a
// lane), and for two query rows the scores' butterflies level by level
// over the chunk's rows at once, each lane finishing one query row after
// the first step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace decode_attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;      // query rows a block holds
constexpr int kMaxRows = 64;  // query rows a kv-head may have (G), in tiles
constexpr int kChunk = 64;   // positions per softmax step; splits are whole chunks

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

// 16 bytes of a K/V row in shared memory as floats (8 int8 values: 8 bytes,
// dequantized with their row's scale).
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// An int8 value x in [-127, 127] times its row's bf16 scale s, rounded to
// bf16 as the reference's dequantize_heads rounds bf16(fp32(x) * s), with
// no conversion instruction a value: a byte permute makes the float
// 2^23 + x + 128, and one FFMA with -(2^23 + 128) s (exact: 24 significant
// bits) leaves x s exactly (at most 15 significant bits, normal for s >=
// 1e-8), which one cvt.rn.bf16x2.f32 a pair rounds as the reference does;
// widening is a shift or a mask.  sc is the row's (s, -(2^23 + 128) s).
// kernels/dequant_bench.py times this against the other exact ways on the
// card.
__device__ __forceinline__ void load16(const int8_t* p, float2 sc, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const unsigned w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};   // bytes x + 128
  const float s = sc.x, nc = sc.y;
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const float p0 = fmaf(__uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440 | (i % 4))),
                          s, nc);
    const float p1 = fmaf(
        __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440 | ((i + 1) % 4))), s, nc);
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    const unsigned v = *reinterpret_cast<const unsigned*>(&h);
    f[i] = __uint_as_float(v << 16);
    f[i + 1] = __uint_as_float(v & 0xFFFF0000u);
  }
}

// load16 on a lane that holds a row's data; zeros on a padded lane (Dh =
// 80), which reads nothing.
template <typename KT, int V>
__device__ __forceinline__ void load16_or_zero(const KT* p, bool has, float (&f)[V]) {
  if (has) {
    load16(p, f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = 0.f;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// How a block of kThreads covers one chunk of K/V rows: copied in 16-byte
// pieces, read by each thread kVec elements at a time (16 bytes, or 8
// int8 values, so an int8 row takes as many registers as a bf16 one).
template <typename KT, int Dh>
struct Tile {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int kVec = kQuant ? 8 : 16 / (int)sizeof(KT);   // elements a read
  static constexpr int kRowVecs = Dh / kVec;          // lanes that hold a row's data
  static constexpr int kLanes =                       // lanes per row (4..32): the
      kRowVecs <= 4 ? 4 : kRowVecs <= 8 ? 8 : kRowVecs <= 16 ? 16 : 32;   // next power of 2
  static constexpr bool kPad = kLanes != kRowVecs;    // lanes past the row (Dh = 80)
  static constexpr int kSlots = kThreads / kLanes;    // rows read at once by the block
  static constexpr int kStage = kChunk * Dh;          // elements of one K or V chunk
  static constexpr int kCopyVec = 16 / (int)sizeof(KT);          // elements per piece
  static constexpr int kCopyLanes = Dh / kCopyVec;               // pieces a row
  static constexpr int kCopies = kChunk * kCopyLanes / kThreads;   // pieces a thread copies
  static_assert(Dh % kVec == 0 && Dh % kCopyVec == 0 && kRowVecs <= 32 &&
                    kChunk % kSlots == 0 && kChunk * kCopyLanes % kThreads == 0 &&
                    !(kPad && kQuant),
                "tile");
};

// Dynamic shared memory of one block: two stages of K and V chunks, the
// chunk's scores [GM][kChunk], then m and l [GM] and a flag; an int8
// cache's two stages of K and V scales [2][2][kChunk] (each with the
// constant load16 adds, two floats) after them, from splice_offset, then
// the chunk's probabilities [kChunk][GM] and corrections [GM].
// After the loop the stages hold the accumulator's per-warp partials
// [kWarps][GM][Dh].
template <typename KT, int Dh, int GM>
__host__ __device__ constexpr int base_bytes() {
  return 4 * Tile<KT, Dh>::kStage * (int)sizeof(KT) + (GM * kChunk + 2 * GM + 4) * 4;
}

// Where a splice policy's (or an int8 cache's scales') shared memory
// starts: after base_bytes, on a 16-byte boundary.
template <typename KT, int Dh, int GM>
__host__ __device__ constexpr int splice_offset() {
  return (base_bytes<KT, Dh, GM>() + 15) & ~15;
}

template <typename KT, int Dh, int GM>
__host__ __device__ constexpr int smem_bytes() {
  return Tile<KT, Dh>::kQuant ? splice_offset<KT, Dh, GM>() + ((8 + GM) * kChunk + GM) * 4
                              : base_bytes<KT, Dh, GM>();
}

struct Args {
  const void* q;      // [rows, G, Dh]
  const void* k;
  const void* v;
  float* out;         // [rows, G, Dh]
  float* part_m;      // [rows, nsplit, G]
  float* part_l;      // [rows, nsplit, G]
  float* part_acc;    // [rows, nsplit, G, Dh]
  int* count;         // [rows * ngt], 0 between launches
  int G;              // query rows a kv-head (the stride of q and out)
  int ngt;            // G tiles: ceil(G / kMaxG)
  int split;          // positions per split, a multiple of kChunk
  int nsplit;
  float scale;
  float cap;                // the score softcap of a kCap kernel
  const void* k_scale;      // an int8 cache's bf16 scales [rows of K/V]
  const void* v_scale;
};

// The block's kv-head: blockIdx.y over the ngt G tiles.
__device__ __forceinline__ int kv_head(int ngt) { return (int)blockIdx.y / ngt; }

// Every position in [lo, hi) is live and K is used as stored.
struct NoSplice {
  static constexpr bool kOn = false;
};

// Copy the live positions of [c0, c0 + n) of the chunk into stage buffers
// ks, vs (a dead position's slot keeps stale data; it is never used).  A
// splice policy gives liveness and row offsets from its descriptors of
// chunk ci, written before the barrier that precedes this copy, or for
// the first chunk (kFirst: no barrier before it) from the tables.
template <typename KT, int Dh, bool kFirst, typename RowFn, typename Splice>
__device__ __forceinline__ void stage_chunk(KT* ks, KT* vs, const KT* __restrict__ k,
                                            const KT* __restrict__ v, const RowFn& row,
                                            const Splice& pol, int ci, int c0, int n) {
  using T = Tile<KT, Dh>;
#pragma unroll
  for (int i = 0; i < T::kCopies; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int j = piece / T::kCopyLanes;
    const int col = (piece % T::kCopyLanes) * T::kCopyVec;
    if constexpr (Splice::kOn && kFirst) {
      long long off;
      if (j < n && pol.direct(c0 + j, off)) {
        cp_async16(ks + j * Dh + col, k + off + col);
        cp_async16(vs + j * Dh + col, v + off + col);
      }
    } else if constexpr (Splice::kOn) {
      if (pol.staged(ci, j)) {
        const long long off = pol.offset(ci, j) + col;
        cp_async16(ks + j * Dh + col, k + off);
        cp_async16(vs + j * Dh + col, v + off);
      }
    } else if (j < n) {
      const long long off = row(c0 + j) + col;
      cp_async16(ks + j * Dh + col, k + off);
      cp_async16(vs + j * Dh + col, v + off);
    }
  }
  cp_async_commit();
}

// The block's work for row rid = b * KVH + h, whose positions are
// [lo, hi); row(t) is the element offset of position t's K/V row.  The
// block serves tile blockIdx.y % ngt of the row's G query rows.  With
// a splice policy (Splice::kOn), row is unused: the policy describes
// chunk c in its shared memory (after this block's, from byte
// splice_offset) by the barrier before chunk c - 1's scores, so its copy
// can be issued at the top of that iteration (chunk 0, copied before any
// barrier, by the first barrier of the loop); pol.live(j, ok) says
// whether row j of the chunk in use is live, and where pol.rotating() a
// pass before the scores has each thread rotate, in shared memory, the
// K row slices it then reads (pol.rotate), so the score loop itself is
// the unspliced one with a liveness test.
template <typename QT, typename KT, int Dh, int GM, bool kCap = false, typename RowFn,
          typename Splice = NoSplice>
__device__ __forceinline__ void decode_block(const Args& a, int rid, int lo, int hi,
                                             const RowFn& row, Splice pol = Splice()) {
  using T = Tile<KT, Dh>;
  constexpr int V = T::kVec;
  constexpr bool kQuant = T::kQuant;
  constexpr bool kPair = kQuant && GM == 2;   // an int8 block's paired butterflies
  const int sp = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this block's query rows [g0, g0 + G) of the kv-head's a.G, and the
  // counter its splits share
  const int tile = (int)blockIdx.y % a.ngt;
  const int g0 = tile * kMaxG;
  const int G = min(kMaxG, a.G - g0);
  const int crow = rid * a.ngt + tile;
  const long long obase = ((long long)rid * a.G + g0) * Dh;
  if (hi <= lo) {                                  // no live position: 0 out
    if (sp == 0)
      for (int e = tid; e < G * Dh; e += kThreads) a.out[obase + e] = 0.f;
    return;
  }
  const int first = lo / a.split;
  const int last = (hi - 1) / a.split;
  if (sp < first || sp > last) return;
  const int nlive = last - first + 1;
  const int s0 = max(lo, sp * a.split);
  const int s1 = min(hi, (sp + 1) * a.split);

  extern __shared__ __align__(16) unsigned char smem[];
  KT* stages = reinterpret_cast<KT*>(smem);                       // [2][K, V][kStage]
  float* sc = reinterpret_cast<float*>(smem + 4 * T::kStage * sizeof(KT));   // [GM][kChunk]
  float* sm_m = sc + GM * kChunk;
  float* sm_l = sm_m + GM;
  int* flag = reinterpret_cast<int*>(sm_l + GM);

  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);
  const int nchunks = (s1 - s0 + kChunk - 1) / kChunk;
  // an int8 cache's scales: thread tid fetches the K (tid < kChunk) or V
  // scale of row tid % kChunk of a chunk into a register, then stores it
  // into stage [c & 1] of qs [2][K, V][kChunk] (0 past the chunk's rows),
  // each beside the constant load16 adds
  float* qs = reinterpret_cast<float*>(smem + splice_offset<KT, Dh, GM>());
  float* pw = qs + 8 * kChunk;     // an int8 block's P [kChunk][GM]
  float* corr_s = pw + GM * kChunk;   // and correction [GM]
  float qnext = 0.f;
  auto fetch_scale = [&](int c0, int n) {
    if constexpr (kQuant) {
      const int j = tid % kChunk;
      const __nv_bfloat16* sp =
          static_cast<const __nv_bfloat16*>(tid < kChunk ? a.k_scale : a.v_scale);
      qnext = j < n ? __bfloat162float(sp[row(c0 + j) / Dh]) : 0.f;
    }
  };
  auto store_scale = [&](int c) {
    if constexpr (kQuant)
      reinterpret_cast<float2*>(qs)[(c & 1) * 2 * kChunk + tid] =
          make_float2(qnext, -8388736.f * qnext);   // load16's (s, -(2^23 + 128) s)
  };
  fetch_scale(s0, min(kChunk, s1 - s0));
  store_scale(0);
  if constexpr (Splice::kOn) {   // chunks 0 and 1's table entries in flight
    pol.bind(smem + splice_offset<KT, Dh, GM>());
    pol.fetch(0, s0, min(kChunk, s1 - s0));
    if (nchunks > 1) pol.fetch(1, s0 + kChunk, min(kChunk, s1 - s0 - kChunk));
  }
  stage_chunk<KT, Dh, true>(stages, stages + T::kStage, k, v, row, pol, 0, s0,
                            min(kChunk, s1 - s0));
  if constexpr (Splice::kOn) {   // warp 0: chunk 0's descriptor and angles, chunk 1's
    pol.store(0, s0, min(kChunk, s1 - s0), nchunks > 1 ? 2 : 1);
    pol.angles(0, 32);
    if (nchunks > 1) pol.store(1, s0 + kChunk, min(kChunk, s1 - s0 - kChunk), 1);
  }

  // this thread's head dims [sub * V, sub * V + V) of rows slot, slot + kSlots, ...
  // (none where sub >= kRowVecs: a padded lane's q, K and V are zeros)
  const int sub = lane % T::kLanes;
  const int slot = tid / T::kLanes;
  const bool has = !T::kPad || sub < T::kRowVecs;
  const QT* q = static_cast<const QT*>(a.q) + obase;
  float qr[GM][V];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) qr[g][e] = g < G && has ? to_f(q[g * Dh + sub * V + e]) : 0.f;
  }

  float m_run[GM], l_run[GM], acc[GM][V];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = s0 + c * kChunk;
    const int n = min(kChunk, s1 - c0);
    cp_async_wait_all();
    __syncthreads();   // chunk c is in; everyone is done with chunk c - 1
    if constexpr (Splice::kOn) {   // chunk c + 2's table reads, ahead of c + 1's copy
      if (c + 2 < nchunks) pol.fetch(c + 2, c0 + 2 * kChunk, min(kChunk, s1 - c0 - 2 * kChunk));
    }
    if (c + 1 < nchunks) {
      KT* nx = stages + ((c + 1) & 1) * 2 * T::kStage;
      stage_chunk<KT, Dh, false>(nx, nx + T::kStage, k, v, row, pol, c + 1, c0 + kChunk,
                                 min(kChunk, s1 - c0 - kChunk));
      fetch_scale(c0 + kChunk, min(kChunk, s1 - c0 - kChunk));
    }
    const float2* ksc = reinterpret_cast<const float2*>(qs) + (c & 1) * 2 * kChunk;   // this
    const float2* vsc = ksc + kChunk;   // chunk's K and V scales
    if constexpr (Splice::kOn) {
      if (c + 1 < nchunks) pol.angles(c + 1, kThreads);
      pol.use(c);
    }
    KT* ks = stages + (c & 1) * 2 * T::kStage;
    const KT* vs = ks + T::kStage;
    if constexpr (Splice::kOn) {   // a rotated chunk's K rows, in place, by their readers
      if (pol.rotating()) {
#pragma unroll 1
        for (int it = 0; it < kChunk / T::kSlots; ++it) {
          const int j = slot + it * T::kSlots;
          pol.template rotate<KT, V>(ks + j * Dh, sub * V, j);
        }
      }
    }

    // 1) scores, kLanes lanes a row; rows >= n (and dead rows) hold stale
    //    data and are masked
    bool live_row[kChunk / T::kSlots];   // a splice policy's liveness, for 3)
    if constexpr (kPair) {
      // two query rows (int8): every row's two dots first, then the
      // butterflies level by level over all the rows at once; the first
      // step hands row 1's partial to the lanes that finish it ([h,
      // kLanes)) and row 0's to the others, so a lane then sums one row:
      // the same sums in the same order as the loop below
      constexpr int kIts = kChunk / T::kSlots;
      constexpr int h = T::kLanes / 2;
      const bool lo = sub < h;
      float x[kIts];
#pragma unroll
      for (int it = 0; it < kIts; ++it) {
        const int j = slot + it * T::kSlots;
        float kf[V];
        load16(ks + j * Dh + sub * V, ksc[j], kf);
        float t0 = 0.f, t1 = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) t0 += qr[0][e] * kf[e];
#pragma unroll
        for (int e = 0; e < V; ++e) t1 += qr[1][e] * kf[e];
        x[it] = lo ? t0 : t1;
        x[it] += __shfl_xor_sync(0xffffffffu, lo ? t1 : t0, h);
      }
#pragma unroll
      for (int o = h / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int it = 0; it < kIts; ++it) x[it] += __shfl_xor_sync(0xffffffffu, x[it], o);
      }
      if (sub % h == 0) {
#pragma unroll
        for (int it = 0; it < kIts; ++it) {
          const int j = slot + it * T::kSlots;
          sc[(lo ? 0 : kChunk) + j] = j < n ? x[it] * a.scale : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < kChunk / T::kSlots; ++it) {
        const int j = slot + it * T::kSlots;
        float kf[V];
        if constexpr (kQuant)
          load16(ks + j * Dh + sub * V, ksc[j], kf);
        else
          load16_or_zero(ks + j * Dh + sub * V, has, kf);
        bool ok = j < n;
        if constexpr (Splice::kOn) ok = pol.live(j, ok);
        live_row[it] = ok;
        float part[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) t += qr[g][e] * kf[e];
          part[g] = t;
        }
#pragma unroll
        for (int o = T::kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int g = 0; g < GM; ++g) part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
        }
        if (sub == 0) {
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            float s = part[g] * a.scale;
            if constexpr (kCap && !kQuant) s = a.cap * tanhf(s / a.cap);
            sc[g * kChunk + j] = ok ? s : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // 2) online softmax over the chunk, in every warp alike; in an int8
    //    block, warp w takes the query rows g = w, w + kWarps, ..., softcaps
    //    there, a position a lane, and leaves the probabilities and the
    //    correction in shared memory for 3): the same values by the same
    //    operations as the other kernels compute them in 1) and 3), once
    float corr[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (kQuant && g % kWarps != warp) continue;
      float x0 = sc[g * kChunk + lane];
      float x1 = sc[g * kChunk + lane + 32];
      if constexpr (kCap && kQuant) {
        if (x0 != -INFINITY) x0 = a.cap * tanhf(x0 / a.cap);
        if (x1 != -INFINITY) x1 = a.cap * tanhf(x1 / a.cap);
      }
      const float m_new = fmaxf(m_run[g], warp_max(fmaxf(x0, x1)));
      float m_exp = m_new;
      // a spliced chunk may have no live position yet: keep -inf - -inf
      // out of the sum, so such a split reaches the combine as (-inf, 0, 0)
      if constexpr (Splice::kOn) m_exp = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(x0 - m_exp);
      const float p1 = expf(x1 - m_exp);
      const float sum = warp_sum(p0 + p1);
      if constexpr (kQuant) {
        pw[lane * GM + g] = p0;
        pw[(lane + 32) * GM + g] = p1;
      }
      corr[g] = m_run[g] == -INFINITY ? 0.f : expf(m_run[g] - m_new);
      l_run[g] = l_run[g] * corr[g] + sum;
      m_run[g] = m_new;
      if (kQuant && lane == 0) corr_s[g] = corr[g];
    }
    if constexpr (kQuant) {
      __syncthreads();   // every query row's probabilities and correction
#pragma unroll
      for (int g = 0; g < GM; ++g) corr[g] = corr_s[g];
    }

    // 3) acc = acc * corr + P V over this thread's rows of the chunk
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= corr[g];
    }
#pragma unroll
    for (int it = 0; it < kChunk / T::kSlots; ++it) {
      const int j = slot + it * T::kSlots;
      if (Splice::kOn ? live_row[it] : j < n) {
        float vf[V];
        if constexpr (kQuant)
          load16(vs + j * Dh + sub * V, vsc[j], vf);
        else
          load16_or_zero(vs + j * Dh + sub * V, has, vf);
        float pj[GM];   // an int8 block's from shared memory, two at a time at GM = 2
        if constexpr (kPair) {
          const float2 t = reinterpret_cast<const float2*>(pw)[j];
          pj[0] = t.x;
          pj[1] = t.y;
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if constexpr (!kPair)
            pj[g] = kQuant ? pw[j * GM + g] : expf(sc[g * kChunk + j] - m_run[g]);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[g][e] += pj[g] * vf[e];
        }
      }
    }
    if constexpr (Splice::kOn) {   // every warp is past chunk c - 1's rows
      if (c + 2 < nchunks)
        pol.store(c + 2, c0 + 2 * kChunk, min(kChunk, s1 - c0 - 2 * kChunk), 1);
    }
    if (c + 1 < nchunks) store_scale(c + 1);   // stage (c + 1) & 1 was chunk c - 1's
  }

  // sum the row slots: the warp's by shuffles, then the warps' in shared memory
#pragma unroll
  for (int o = T::kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  __syncthreads();   // the stages are free
  float* red = reinterpret_cast<float*>(smem);   // [kWarps][GM][Dh]
  if (lane < T::kRowVecs) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < V; ++e) red[(warp * GM + g) * Dh + sub * V + e] = acc[g][e];
    }
  }
  if (kQuant ? lane == 0 : tid == 0) {   // an int8 block's rows from their warps
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (kQuant && g % kWarps != warp) continue;
      sm_m[g] = m_run[g];
      sm_l[g] = l_run[g];
    }
  }
  __syncthreads();

  // split s's partials of query row g: m and l at pm(s) + g, acc at
  // pa(s) + g * Dh (a.G rows a split; this block's from g0)
  const long long pbase = (long long)rid * a.nsplit;   // this row's first split slot
  auto pm = [&](int s) { return (pbase + s) * a.G + g0; };
  auto pa = [&](int s) { return ((pbase + s) * a.G + g0) * Dh; };
  for (int e = tid; e < G * Dh; e += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * GM * Dh + e];
    if (nlive == 1)
      a.out[obase + e] = t / fmaxf(sm_l[e / Dh], 1e-20f);
    else
      a.part_acc[pa(sp) + e] = t;
  }
  if (nlive == 1) return;
  if (tid < G) {
    a.part_m[pm(sp) + tid] = sm_m[tid];
    a.part_l[pm(sp) + tid] = sm_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.count + crow, 1) == nlive - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last live split: rescale every live split to one maximum, in order
  for (int e = tid; e < G * Dh; e += kThreads) {
    const int g = e / Dh;
    float mx = -INFINITY;
    for (int s = first; s <= last; ++s) mx = fmaxf(mx, __ldcg(a.part_m + pm(s) + g));
    float l = 0.f, o = 0.f;
    for (int s = first; s <= last; ++s) {
      const float w = expf(__ldcg(a.part_m + pm(s) + g) - mx);
      l += __ldcg(a.part_l + pm(s) + g) * w;
      o += __ldcg(a.part_acc + pa(s) + e) * w;
    }
    a.out[obase + e] = o / fmaxf(l, 1e-20f);
  }
  if (tid == 0) a.count[crow] = 0;
}

// Launch kernel<<<grid, kThreads, smem>>> on the stream, after raising
// the kernel's dynamic shared memory limit (once per device).
template <auto kernel, typename... Ts>
int launch_kernel(int smem, dim3 grid, cudaStream_t stream, Ts... args) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace decode_attn
