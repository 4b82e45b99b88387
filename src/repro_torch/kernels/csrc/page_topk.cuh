// Masked inner-product top-k over the resident pool pages, shared by the
// fused (probe_topk.cu) and the unfused (ivf_topk.cu) retrieval kernels.
// The two differ only in how a (query, page) pair is admitted: by the
// page's cluster in a [B, Nc] admitted mask (ClusterAdmit), or by a page
// mask given by the caller (PageMaskAdmit).
//
// One grid a call, search and merge together (search_kernel):
//   * a persistent grid of one block per SM.  Work units are (page, chunk
//     of `rows` rows) of the pages some query admits.  Every block first
//     marks the live pages of a window of up to kWindow pages in a shared
//     bitmap (a warp ballot over 32 pages, each the OR of its queries'
//     admission), so a page no query admits costs one admission check and
//     no block; then it takes its own contiguous range of the window's
//     live units, an equal share (to one unit) of the live bytes.  The
//     range follows from the live ranks alone, so the plan needs no work
//     counter and the same inputs always give the same partition;
//   * staged path (d % 8 == 0, d <= 1024, 16-byte aligned rows): a unit's
//     rows are contiguous, so one thread copies each unit into a ring of
//     `stages` shared-memory buffers with one 1-D TMA bulk copy
//     (cp.async.bulk, completion on an mbarrier), `stages` - 1 units ahead
//     of the compute.  Direct path (any d): rows are read from global
//     memory with scalar loads and q from global memory (L1);
//   * one warp a row, kRowsAtOnce rows at once.  Each lane keeps its
//     16-byte column slices of up to kGroup queries in registers (24 fp32
//     a query at d = 768), dots the rows in fp32 only for the queries that
//     admit the page, and a row's four sums leave the warp in one
//     transposed reduction (6 shuffles).  The next unit's admission bits
//     and row ids are loaded while this one computes, so no global load
//     waits inside a unit;
//   * the unit's scores go to a double-buffered shared array; after one
//     barrier a unit, the warp that owns a query folds them into the
//     block's running top-k of that query, keyed by (score desc, flat
//     position page * ps + row asc), in shared memory.  Rows whose id is
//     -1 never enter;
//   * queries go in passes of up to kMaxPass (one owner warp each); a
//     pass streams the pages once.  Each block writes its [B, k] lists
//     once, takes a ticket from a counter, and the last block merges the
//     blocks' lists per query (one warp a query, each lane holding its
//     candidates in registers when they fit), writes the [B, k]
//     result and resets the counter to 0 for the next launch.  Slots no
//     vector fills are (-inf, -1).
// The order is total, so the result does not depend on the partition or
// on which block finishes last: two calls give equal bits.
//
// Layouts: q [B, d] fp32; pages [P, ps, d] bf16; page_ids [P, ps] int32;
// cand_s / cand_o [blocks, B, k] scratch; count: one int, 0 between
// launches.  The wrapper's plan (kernels/page_topk.py) picks rows,
// stages, the pass size and the grid, and mirrors smem_layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace page_topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                    // queries a warp dots at once
constexpr int kMaxPass = 8;                  // queries a pass (one owner warp each)
constexpr int kMaxStages = 4;
constexpr int kMaxPieces = 4;                // 16-byte pieces a lane holds: d <= 1024
constexpr int kWindow = kThreads * 32 * 8;   // pages a bitmap covers (8 KB)
constexpr int kScanUnroll = 8;               // pages a thread checks at once
constexpr int kRowsAtOnce = 4;               // rows a warp dots at once
constexpr int kMergeRegs = 16;               // candidates a lane holds in the merge
constexpr int kSmemLimit = 232448;           // 227 KB a block on the H100
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// (s, o) ranks before (bs, bo) in the order (score desc, ordinal asc)
__device__ __forceinline__ bool better(float s, int o, float bs, int bo) {
  return s > bs || (s == bs && o < bo);
}

// (s, o) comes strictly after (ps, po)
__device__ __forceinline__ bool after(float s, int o, float ps, int po) {
  return s < ps || (s == ps && o > po);
}

__device__ __forceinline__ void warp_best(float& s, int& o) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(kFull, s, off);
    const int o2 = __shfl_xor_sync(kFull, o, off);
    if (better(s2, o2, s, o)) {
      s = s2;
      o = o2;
    }
  }
}

// The four lanes' partial sums a[0..3] summed over the warp in 6 shuffles:
// lane l returns the sum of query (l >> 3) & 3.
__device__ __forceinline__ float reduce4(const float (&a)[kGroup], int lane) {
  const bool h16 = lane & 16;
  float k0 = h16 ? a[2] : a[0];
  float k1 = h16 ? a[3] : a[1];
  k0 += __shfl_xor_sync(kFull, h16 ? a[0] : a[2], 16);
  k1 += __shfl_xor_sync(kFull, h16 ? a[1] : a[3], 16);
  const bool h8 = lane & 8;
  float v = h8 ? k1 : k0;
  v += __shfl_xor_sync(kFull, h8 ? k0 : k1, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

// query b0 + t may search page p iff bit t of bits(p, b0, nq) is set
// (t < nq <= kMaxPass).  bits_of(key(p), ...) splits the lookup in two so
// a scan can issue every key's load, then every bit's, with no branch
// between them: both load from a clamped address whatever the outcome.
//
// By the page's cluster: admit [B, Nc]; page_cluster [P], -1 = unsearchable.
struct ClusterAdmit {
  const uint8_t* admit;
  const int* page_cluster;
  int Nc;
  __device__ __forceinline__ int key(int p) const { return page_cluster[p]; }
  __device__ __forceinline__ unsigned bits_of(int c, int b0, int nq) const {
    const bool ok = c >= 0 && c < Nc;
    const long long col = ok ? c : 0;
    unsigned m = 0;
#pragma unroll
    for (int t = 0; t < kMaxPass; ++t)
      if (admit[(long long)(b0 + min(t, nq - 1)) * Nc + col] && t < nq) m |= 1u << t;
    return ok ? m : 0u;
  }
  __device__ __forceinline__ unsigned bits(int p, int b0, int nq) const {
    return bits_of(key(p), b0, nq);
  }
};

// By mask[b * stride + p]: a per-query [B, P] mask has stride P, one [P]
// mask shared by every query stride 0.
struct PageMaskAdmit {
  const uint8_t* mask;
  int stride;
  __device__ __forceinline__ int key(int p) const { return p; }
  __device__ __forceinline__ unsigned bits_of(int p, int b0, int nq) const {
    unsigned m = 0;
#pragma unroll
    for (int t = 0; t < kMaxPass; ++t)
      if (mask[(long long)(b0 + min(t, nq - 1)) * stride + p] && t < nq) m |= 1u << t;
    return m;
  }
  __device__ __forceinline__ unsigned bits(int p, int b0, int nq) const {
    return bits_of(p, b0, nq);
  }
};

struct Plan {
  int rows;     // rows a unit (a chunk of one page)
  int stages;   // ring depth of the staged path; 0 = direct path
  int pass;     // queries a pass, 1..kMaxPass
};

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// Dynamic shared memory of one block, in this order: the stage ring,
// the mbarriers, the live-page bitmap, the double-buffered unit scores
// [2][pass][rows], the running lists (scores [pass][k], ordinals
// [pass][k]) and a few ints.  kernels/page_topk.py mirrors it.
struct Layout {
  long long stage, bars, bitmap, scores, list_s, list_o, misc, total;
};

__host__ __device__ inline Layout smem_layout(const Plan& pl, int d, int k) {
  Layout L;
  L.stage = pl.stages ? round_up((long long)pl.rows * d * 2, 128) : 0;
  L.bars = pl.stages * L.stage;
  L.bitmap = L.bars + 8 * kMaxStages;
  L.scores = L.bitmap + kWindow / 8;
  L.list_s = L.scores + 2LL * pl.pass * pl.rows * 4;
  L.list_o = L.list_s + (long long)pl.pass * k * 4;
  L.misc = round_up(L.list_o + (long long)pl.pass * k * 4, 16);
  L.total = L.misc + 16 * 4;
  return L;
}

// -- TMA bulk copies on mbarriers (sm_90) ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) into
// shared memory; the copy completes the barrier's current phase
__device__ __forceinline__ void tma_load(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// -- the live units of a window --------------------------------------------

// The next unit after (page, chunk) in live order: pages are window-relative
// indices into the bitmap of `words` words.
struct Cursor {
  int page, chunk;
  __device__ __forceinline__ void next(const unsigned* bitmap, int words, int nch) {
    if (++chunk < nch) return;
    chunk = 0;
    const int rel = page + 1;
    int w = rel >> 5;
    unsigned m = w < words ? bitmap[w] & (kFull << (rel & 31)) : 0u;
    while (!m && ++w < words) m = bitmap[w];
    page = m ? w * 32 + __ffs(m) - 1 : words * 32;
  }
};

// exclusive block-wide prefix of v; `total` gets the sum over the block
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    if (w < warp) before += t;
    tot += t;
  }
  __syncthreads();
  total = tot;
  return before + x - v;
}

// insert (s, o) into the sorted list (Ls, Lo) of k entries, if it belongs
__device__ __forceinline__ void insert(float* Ls, int* Lo, int k, float s, int o) {
  if (!better(s, o, Ls[k - 1], Lo[k - 1])) return;
  int i = k - 1;
  while (i > 0 && better(s, o, Ls[i - 1], Lo[i - 1])) {
    Ls[i] = Ls[i - 1];
    Lo[i] = Lo[i - 1];
    --i;
  }
  Ls[i] = s;
  Lo[i] = o;
}

__device__ __forceinline__ void bf16x8(const uint4& raw, float (&x)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// -- the kernel --------------------------------------------------------------

// kStaged: NP = 16-byte pieces a lane holds (ceil(d / 256)); else the
// direct path (NP unused).
template <class Admit, bool kStaged, int NP>
__global__ void __launch_bounds__(kThreads, 1)
search_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ pages,
              const int* __restrict__ page_ids, Admit admitted, float* __restrict__ cand_s,
              int* __restrict__ cand_o, int* __restrict__ count, float* __restrict__ out_s,
              int* __restrict__ out_i, int B, int P, int ps, int d, int k, Plan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = smem_layout(pl, d, k);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  unsigned* bitmap = reinterpret_cast<unsigned*>(smem + L.bitmap);
  float* sc = reinterpret_cast<float*>(smem + L.scores);
  float* list_s = reinterpret_cast<float*>(smem + L.list_s);
  int* list_o = reinterpret_cast<int*>(smem + L.list_o);
  int* misc = reinterpret_cast<int*>(smem + L.misc);   // [0, kWarps) scan; 8, 9 start; 10 flag

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = pl.rows;
  const int nch = (ps + rows - 1) / rows;
  const int d8 = d / 8;
  const long long nb = gridDim.x;
  const long long bid = blockIdx.x;

  if (kStaged && tid == 0) {
    for (int s = 0; s < pl.stages; ++s) mbar_init(&bars[s]);
    mbar_fence_init();
  }
  __syncthreads();
  unsigned uses = 0;   // units staged by this block so far: the ring position

  float qr[kGroup][kStaged ? NP * 8 : 1];
  int loaded = -1;     // first query held in qr

  for (int b0 = 0; b0 < B; b0 += pl.pass) {
    const int nq = min(pl.pass, B - b0);
    for (int e = tid; e < nq * k; e += kThreads) {
      list_s[e] = -INFINITY;
      list_o[e] = kNone;
    }
    for (int w0 = 0; w0 < P; w0 += kWindow) {
      const int wn = min(kWindow, P - w0);
      const int words = (wn + 31) / 32;

      // 1) the window's live pages, one ballot of 32 pages a warp; every
      //    load of a round is issued before the first is needed
      for (int base = 0; base < wn; base += kThreads * kScanUnroll) {
        int key[kScanUnroll];
        unsigned m[kScanUnroll];
#pragma unroll
        for (int u = 0; u < kScanUnroll; ++u)
          key[u] = admitted.key(w0 + min(base + u * kThreads + tid, wn - 1));
#pragma unroll
        for (int u = 0; u < kScanUnroll; ++u) m[u] = admitted.bits_of(key[u], b0, nq);
#pragma unroll
        for (int u = 0; u < kScanUnroll; ++u) {
          const unsigned bits =
              __ballot_sync(kFull, base + u * kThreads + tid < wn && m[u] != 0u);
          const int w = (base + u * kThreads) / 32 + warp;
          if (lane == 0 && w < words) bitmap[w] = bits;
        }
      }
      __syncthreads();

      // 2) live ranks: thread t counts words [t * wpt, (t + 1) * wpt)
      const int wpt = (words + kThreads - 1) / kThreads;
      int mine = 0;
      for (int i = 0; i < wpt; ++i) {
        const int w = tid * wpt + i;
        if (w < words) mine += __popc(bitmap[w]);
      }
      int live_total;
      const int before = block_scan(mine, misc, live_total);

      // 3) this block's units [u0, u1) of the window's live units, and
      //    the page and chunk of u0
      const long long U = (long long)live_total * nch;
      const long long u0 = U * bid / nb, u1 = U * (bid + 1) / nb;
      const int n = (int)(u1 - u0);
      if (n > 0) {
        const int r0 = (int)(u0 / nch);   // live rank of the first page
        if (r0 >= before && r0 < before + mine) {
          int left = r0 - before;
          for (int i = 0; i < wpt; ++i) {
            const int w = tid * wpt + i;
            unsigned m = w < words ? bitmap[w] : 0u;
            const int c = __popc(m);
            if (left < c) {
              for (int j = 0; j < left; ++j) m &= m - 1;
              misc[8] = w * 32 + __ffs(m) - 1;
              misc[9] = (int)(u0 % nch);
              break;
            }
            left -= c;
          }
        }
      }
      __syncthreads();
      Cursor cur{misc[8], misc[9]};   // the unit being computed, in every thread
      Cursor ahead = cur;             // the next unit to stage (thread 0)

      if (kStaged && tid == 0) {
        for (int j = 0; j < min(pl.stages, n); ++j) {
          const int s = (uses + j) % pl.stages;
          const int r = ahead.chunk * rows;
          tma_load(smem + s * L.stage, pages + ((long long)(w0 + ahead.page) * ps + r) * d,
                   (uint32_t)(min(rows, ps - r) * d * 2), &bars[s]);
          ahead.next(bitmap, words, nch);
        }
      }

      // 4) the units, one barrier each.  The next unit's admission bits
      //    and row ids are loaded while this one computes: lane l of a
      //    warp holds the id of the warp's row warp + kWarps * l.
      Cursor nxt = cur;
      unsigned adm_next = 0;
      int id_next = -1;
      auto prefetch = [&](const Cursor& c) {
        const int page = w0 + c.page;
        const int r_first = c.chunk * rows;
        const int rr = warp + kWarps * lane;
        adm_next = admitted.bits(page, b0, nq);
        id_next = rr < min(rows, ps - r_first) ? page_ids[(long long)page * ps + r_first + rr]
                                                : -1;
      };
      if (n > 0) prefetch(nxt);
      for (int j = 0; j < n; ++j) {
        const int page = w0 + cur.page;
        const int r_first = cur.chunk * rows;
        const int nrows = min(rows, ps - r_first);
        const unsigned adm = adm_next;
        const int my_id = id_next;
        if (j + 1 < n) {
          nxt.next(bitmap, words, nch);
          prefetch(nxt);
        }
        float* sb = sc + (j & 1) * pl.pass * rows;   // this unit's [pass][rows]
        const unsigned jt = uses + j;
        const int s = jt % (kStaged ? pl.stages : 1);
        if (kStaged) mbar_wait(&bars[s], (jt / pl.stages) & 1u);
        const __nv_bfloat16* st = kStaged
            ? reinterpret_cast<const __nv_bfloat16*>(smem + s * L.stage)
            : pages + ((long long)page * ps + r_first) * d;
        const int per_warp = (nrows - warp + kWarps - 1) / kWarps;   // rows of this warp

        for (int t0 = 0; t0 < nq; t0 += kGroup) {
          const unsigned gm = (adm >> t0) & 0xfu;
          if (!gm) continue;
          if (kStaged && loaded != b0 + t0) {
#pragma unroll
            for (int t = 0; t < kGroup; ++t) {
              const int b = b0 + t0 + t;
#pragma unroll
              for (int pi = 0; pi < NP; ++pi) {
                const int i8 = lane + 32 * pi;
#pragma unroll
                for (int u = 0; u < 8; ++u)
                  qr[t][pi * 8 + u] =
                      (t0 + t < nq && i8 < d8) ? q[(long long)b * d + i8 * 8 + u] : 0.f;
              }
            }
            loaded = b0 + t0;
          }
          for (int i0 = 0; i0 < per_warp; i0 += kRowsAtOnce) {
            float acc[kRowsAtOnce][kGroup];
#pragma unroll
            for (int i = 0; i < kRowsAtOnce; ++i) {
#pragma unroll
              for (int t = 0; t < kGroup; ++t) acc[i][t] = 0.f;
            }
            if (kStaged) {
#pragma unroll
              for (int pi = 0; pi < NP; ++pi) {
                const int i8 = lane + 32 * pi;
                if (i8 < d8) {
#pragma unroll
                  for (int i = 0; i < kRowsAtOnce; ++i) {
                    if (i0 + i < per_warp) {
                      const int r = warp + kWarps * (i0 + i);
                      float x[8];
                      bf16x8(*reinterpret_cast<const uint4*>(st + (long long)r * d + i8 * 8), x);
#pragma unroll
                      for (int t = 0; t < kGroup; ++t) {
                        if (gm >> t & 1u) {
#pragma unroll
                          for (int u = 0; u < 8; ++u)
                            acc[i][t] = fmaf(qr[t][pi * 8 + u], x[u], acc[i][t]);
                        }
                      }
                    }
                  }
                }
              }
            } else {
#pragma unroll
              for (int i = 0; i < kRowsAtOnce; ++i) {
                if (i0 + i < per_warp) {
                  const __nv_bfloat16* row = st + (long long)(warp + kWarps * (i0 + i)) * d;
                  for (int e = lane; e < d; e += 32) {
                    const float x = __bfloat162float(row[e]);
#pragma unroll
                    for (int t = 0; t < kGroup; ++t)
                      if (gm >> t & 1u)
                        acc[i][t] = fmaf(q[(long long)(b0 + t0 + t) * d + e], x, acc[i][t]);
                  }
                }
              }
            }
            const int t = (lane >> 3) & 3;
#pragma unroll
            for (int i = 0; i < kRowsAtOnce; ++i) {
              const float v = reduce4(acc[i], lane);
              const int id = __shfl_sync(kFull, my_id, (i0 + i) & 31);
              if (i0 + i < per_warp && (lane & 7) == 0 && t0 + t < nq)
                sb[(t0 + t) * rows + warp + kWarps * (i0 + i)] =
                    (gm >> t & 1u) && id >= 0 ? v : -INFINITY;
            }
          }
        }
        __syncthreads();   // the unit's scores are in; its stage is free

        if (kStaged && tid == 0 && j + pl.stages < n) {
          const int r = ahead.chunk * rows;
          tma_load(smem + s * L.stage, pages + ((long long)(w0 + ahead.page) * ps + r) * d,
                   (uint32_t)(min(rows, ps - r) * d * 2), &bars[s]);
          ahead.next(bitmap, words, nch);
        }

        // fold the scores into the owner warp's running top-k
        for (int t = warp; t < nq; t += kWarps) {
          if (!(adm >> t & 1u)) continue;
          float* Ls = list_s + t * k;
          int* Lo = list_o + t * k;
          const float* srow = sb + t * rows;
          const int obase = page * ps + r_first;
          for (int r0 = 0; r0 < nrows; r0 += 32) {
            const int r = r0 + lane;
            const float sv = r < nrows ? srow[r] : -INFINITY;
            const bool c = sv != -INFINITY && better(sv, obase + r, Ls[k - 1], Lo[k - 1]);
            unsigned m = __ballot_sync(kFull, c);
            if (lane == 0) {
              while (m) {
                const int rr = r0 + __ffs(m) - 1;
                m &= m - 1;
                insert(Ls, Lo, k, srow[rr], obase + rr);
              }
            }
            __syncwarp();
          }
        }
        cur = nxt;
      }
      uses += n;
      __syncthreads();   // the bitmap and misc are free for the next window
    }

    // the pass's lists, once, by their owner warps
    for (int t = warp; t < nq; t += kWarps) {
      for (int j = lane; j < k; j += 32) {
        const long long o = (bid * B + b0 + t) * k + j;
        cand_s[o] = list_s[t * k + j];
        cand_o[o] = list_o[t * k + j];
      }
    }
    __syncthreads();
  }

  // the last block to finish merges every block's lists
  __threadfence();
  __syncthreads();
  if (tid == 0) misc[10] = atomicAdd(count, 1) == (int)nb - 1;
  __syncthreads();
  if (!misc[10]) return;
  __threadfence();
  // candidate e is slot e % k of block e / k; with at most 32 *
  // kMergeRegs of them a lane loads all of its own at once.  out_i holds
  // the winners' flat positions until the ids replace them.
  const int n = (int)nb * k;
  for (int b = warp; b < B; b += kWarps) {
    float cs[kMergeRegs];
    int co[kMergeRegs];
    const bool in_regs = n <= 32 * kMergeRegs;
    if (in_regs) {
#pragma unroll
      for (int i = 0; i < kMergeRegs; ++i) {
        const int e = min(lane + 32 * i, n - 1);
        const long long o = ((long long)(e / k) * B + b) * k + e % k;
        cs[i] = __ldcg(cand_s + o);
        co[i] = lane + 32 * i < n ? __ldcg(cand_o + o) : kNone;
      }
    }
    float prev_s = INFINITY;
    int prev_o = -1;
    for (int j = 0; j < k; ++j) {
      float best = -INFINITY;
      int bo = kNone;
      if (in_regs) {
#pragma unroll
        for (int i = 0; i < kMergeRegs; ++i) {
          if (co[i] != kNone && after(cs[i], co[i], prev_s, prev_o) &&
              better(cs[i], co[i], best, bo)) {
            best = cs[i];
            bo = co[i];
          }
        }
      } else {
        for (int e = lane; e < n; e += 32) {
          const long long o = ((long long)(e / k) * B + b) * k + e % k;
          const float s = __ldcg(cand_s + o);
          const int so = __ldcg(cand_o + o);
          if (so != kNone && after(s, so, prev_s, prev_o) && better(s, so, best, bo)) {
            best = s;
            bo = so;
          }
        }
      }
      warp_best(best, bo);
      if (lane == 0) {
        const bool found = bo != kNone && best != -INFINITY;
        out_s[(long long)b * k + j] = found ? best : -INFINITY;
        out_i[(long long)b * k + j] = found ? bo : -1;
      }
      prev_s = best;
      prev_o = bo;
    }
    __syncwarp();
    for (int j = lane; j < k; j += 32) {
      const int o = out_i[(long long)b * k + j];
      out_i[(long long)b * k + j] = o >= 0 ? page_ids[o] : -1;
    }
  }
  if (tid == 0) *count = 0;
}

// Launch the search of `admitted` on stream s: checks the plan, raises the
// kernel's shared-memory limit once per device, one grid of `blocks`.
template <class Admit, bool kStaged, int NP>
int launch_search(const float* q, const void* pages, const int* page_ids, Admit admitted,
                  float* cand_s, int* cand_o, int* count, float* out_s, int* out_i, int B,
                  int P, int ps, int d, int k, const Plan& pl, int blocks, int smem,
                  cudaStream_t s) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  auto kernel = search_kernel<Admit, kStaged, NP>;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  kernel<<<blocks, kThreads, smem, s>>>(q, static_cast<const __nv_bfloat16*>(pages), page_ids,
                                        admitted, cand_s, cand_o, count, out_s, out_i, B, P, ps,
                                        d, k, pl);
  return (int)cudaGetLastError();
}

// The search and merge in one grid on stream s; returns the first CUDA
// error, 0 on success.  The staged path needs d % 8 == 0, d <= 1024 and a
// 16-byte aligned page slab.
template <class Admit>
int search(const float* q, const void* pages, const int* page_ids, Admit admitted,
           float* cand_s, int* cand_o, int* count, float* out_s, int* out_i, int B, int P,
           int ps, int d, int k, const Plan& pl, int blocks, cudaStream_t s) {
  const bool staged = pl.stages > 0;
  if (pl.rows < 1 || pl.pass < 1 || pl.pass > kMaxPass || blocks < 1 ||
      (staged && (pl.stages < 2 || pl.stages > kMaxStages || d % 8 ||
                  d > 8 * 32 * kMaxPieces || reinterpret_cast<uintptr_t>(pages) % 16)) ||
      (long long)P * ps >= kNone)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_layout(pl, d, k).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (!staged)
    return launch_search<Admit, false, 1>(q, pages, page_ids, admitted, cand_s, cand_o, count,
                                          out_s, out_i, B, P, ps, d, k, pl, blocks, (int)smem,
                                          s);
  switch ((d / 8 + 31) / 32) {
    case 1:
      return launch_search<Admit, true, 1>(q, pages, page_ids, admitted, cand_s, cand_o, count,
                                           out_s, out_i, B, P, ps, d, k, pl, blocks, (int)smem,
                                           s);
    case 2:
      return launch_search<Admit, true, 2>(q, pages, page_ids, admitted, cand_s, cand_o, count,
                                           out_s, out_i, B, P, ps, d, k, pl, blocks, (int)smem,
                                           s);
    case 3:
      return launch_search<Admit, true, 3>(q, pages, page_ids, admitted, cand_s, cand_o, count,
                                           out_s, out_i, B, P, ps, d, k, pl, blocks, (int)smem,
                                           s);
    default:
      return launch_search<Admit, true, 4>(q, pages, page_ids, admitted, cand_s, cand_o, count,
                                           out_s, out_i, B, P, ps, d, k, pl, blocks, (int)smem,
                                           s);
  }
}

}  // namespace page_topk
