// Absorbed multi-head latent attention for one new token (MLA decode,
// minicpm3): for each row b and head h,
//   s_t = (q_abs[b,h] . ckv[b,t] + q_pe[b,h] . kpe[b,t]) * scale,  t <= pos[b]
//   out[b,h] = softmax_t(s) . ckv[b,t]                  (the latent, [R])
// all in fp32 from a bf16 or fp32 cache, as the reference's mla_decode
// computes it in jnp (src/repro/models/mla.py); the W_uk absorption before
// and the W_uv expansion after stay plain products outside the kernel.
//
// Replaces: no TPU kernel.  The reference runs this attention as jnp
// einsums in every mode (src/repro/models/mla.py, mla_decode); the port
// gives it a kernel of its own, as it did the spliced decode.
//
// Bound on an H100: bytes, on the tensor cores.  Every head shares the one
// latent row a position (one "kv head" with G = H), so a position's R + Dr
// key values and R value values are read once for all H heads: at
// minicpm3's H = 40, R = 256, Dr = 32 a position is 576 bytes in bf16
// against 2 H (2 R + Dr) = 43,520 flops, past the fp32 rate (67 TFLOP/s)
// but not the tensor cores' (989 TFLOP/s bf16) even three times over.
//
// The split product.  The reference multiplies fp32 queries and
// probabilities with the cache in fp32.  A bf16 cache value is exact in
// bf16, and an fp32 value x splits exactly into three bf16 pieces by
// truncation: x1 = x with its low 16 bits cleared, x2 the same of x - x1,
// x3 = x - x1 - x2 (x's 24 significant bits, 8 a piece; each difference
// exact in fp32; below |x| = 2^-110 x3 would be subnormal and its bf16
// misses x by less than 2^-133).  Each bf16 x bf16 product is exact in
// fp32, so
//   q . k = q1 . k + q2 . k + q3 . k,   P . v = P1 . v + P2 . v + P3 . v
// are the fp32 products of the reference, summed in fp32 in another order
// (the tensor cores' accumulation).  A single bf16 or TF32 product would
// round q or P and move the result by about 1e-3; three bf16 products on
// the tensor cores cost 3 x 1.43 GFLOP / 989 TFLOP/s = 0.0043 ms at
// minicpm3's long context (B 4, S 8192), under its 0.0056 ms of bytes.
//
// The bf16 kernel (mma.sync.m16n8k16, fp32 sums):
//   * grid (split, head tile, b): a block takes 16 heads (40 heads are
//     three tiles, the last half padded with zero queries) and one split
//     of the row's positions, so a short context still spreads over
//     B x tiles x splits blocks; each block splits its tile's queries once
//     into three bf16 pieces in shared memory;
//   * 4 warps; positions in chunks of 64, each chunk's [ckv | kpe] rows
//     copied by 16-byte cp.async, double buffered, rows padded to an odd
//     number of 16-byte units so that ldmatrix reads no bank twice; rows
//     past the split are zeros, never stale data (0 x NaN would poison P.v);
//   * scores: warp w takes positions 16w..16w+15 of the chunk for all 16
//     heads: A = a query piece by ldmatrix, B = the K rows by ldmatrix,
//     three products a 16-deep step into three accumulators;
//   * online softmax per head in fp32, as before: each warp's chunk max
//     through shared memory (one barrier), the same (max, correction) in
//     every warp, each thread's share of the sum kept apart and summed at
//     the end; the probabilities go to shared memory as three bf16 pieces;
//   * P . ckv: warp w owns R / 4 latent columns of the 16 heads (a 16 x 64
//     fp32 accumulator, 32 registers a thread at R = 256), P's pieces read
//     by ldmatrix, ckv's rows by ldmatrix.trans;
//   * splits of a (row, tile) combine in the same launch, as the decode
//     kernels' do (decode_attn.cuh): partial (m, l, acc) to scratch, a
//     ticket per (row, tile); the last split reads every split's (m, l)
//     at once, computes one weight a (split, head) and sums the tile's
//     latent elements over the splits in split order, a thread's float4s
//     of a split loaded together.
// The fp32 cache (only the reduced configs held against the CPU) keeps
// the CUDA-core kernel below it: a block holds every head's fp32 query and
// scores 32 positions a chunk, one a lane, from broadcast reads.
//
// Layouts: q_abs [B, H, R] and q_pe [B, H, Dr] fp32; ckv [B, S, R] and
// kpe [B, S, Dr] bf16 or fp32; pos [B] int32; out [B, H, R] fp32; scratch
// [B, nsplit, H] m and l, [B, nsplit, H, R] acc (16-byte aligned); count
// [B x tiles] int32 (one a row for fp32), zero before the first launch
// (each launch leaves it zero).  Takes H = 1..64 and (R, Dr) = (256, 32)
// (minicpm3) or (32, 16) (its reduced config), any S >= 1; splits of 64
// positions a multiple (bf16) or 32 (fp32); rows 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxH = 64;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Args {
  const float* q_abs;   // [B, H, R]
  const float* q_pe;    // [B, H, Dr]
  const void* ckv;      // [B, S, R]
  const void* kpe;      // [B, S, Dr]
  const int* pos;       // [B]
  float* out;           // [B, H, R]
  float* part_m;        // [B, nsplit, H]
  float* part_l;
  float* part_acc;      // [B, nsplit, H, R]
  int* count;           // [B x tiles]
  int S, H, split, nsplit;
  float scale;
};

// Launch kernel<<<grid, threads, smem>>> after raising its dynamic shared
// memory limit to `most` (once per device).
template <auto kernel>
int launch_kernel(int threads, int smem, int most, dim3 grid, cudaStream_t stream,
                  const Args& a) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the bf16 cache: split bf16 products on the tensor cores ---------------

namespace tc {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;     // heads a block: the mma's M
constexpr int kChunk = 64;    // positions a step: 16 a warp
constexpr int kPRow = kChunk + 8;   // a probability row in shared memory (odd 16-byte units)

template <int R, int Dr>
struct Geo {
  static constexpr int kD = R + Dr;          // key width: [ckv | kpe]
  static constexpr int kRow = kD + 8;        // a staged row or query row: odd 16-byte units
  static constexpr int kSteps = kD / 16;     // 16-deep steps of a score
  static constexpr int kUnitsR = R / 8;      // 16-byte pieces of a ckv row
  static constexpr int kUnits = kD / 8;      // of a key row
  static constexpr int kCols = R / kWarps;   // latent columns a warp
  static constexpr int kNT = kCols / 8;      // their 8-column mma tiles
  static constexpr int kStage = kChunk * kRow;
  static_assert(kD % 16 == 0 && kCols % 8 == 0 && (kRow / 8) % 2 == 1, "geometry");
};

// queries [3][kTile][kRow], stages [2][kStage] and probabilities
// [3][kTile][kPRow] (bf16; the combine's weights after the loop), then the
// warps' chunk maxima and sums [kWarps][kTile] (fp32) and a flag
template <int R, int Dr>
constexpr int work_bytes() {
  using T = Geo<R, Dr>;
  return (3 * kTile * T::kRow + 2 * T::kStage + 3 * kTile * kPRow) * 2;
}

template <int R, int Dr>
constexpr int smem_bytes() {
  return work_bytes<R, Dr>() + 2 * kWarps * kTile * 4 + 16;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// d += a . b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 fp32
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = x1 + x2 + x3 exactly, each piece a bf16 value in the high half of
// its word (truncation: the differences are exact in fp32, and what is
// left after two pieces has at most 8 significant bits)
__device__ __forceinline__ void split3(float x, unsigned (&p)[3]) {
  p[0] = __float_as_uint(x) & 0xFFFF0000u;
  const float r1 = __fsub_rn(x, __uint_as_float(p[0]));
  p[1] = __float_as_uint(r1) & 0xFFFF0000u;
  p[2] = __float_as_uint(__fsub_rn(r1, __uint_as_float(p[1])));
}

// two pieces' bf16 halves as one bf16x2 word, lo first
__device__ __forceinline__ unsigned pack(unsigned lo, unsigned hi) {
  return __byte_perm(lo, hi, 0x7632);
}

template <int R, int Dr>
__global__ void __launch_bounds__(kThreads, 2) mla_tc_kernel(Args a) {
  using T = Geo<R, Dr>;
  using bf16 = __nv_bfloat16;
  constexpr int kRow = T::kRow;
  const int b = blockIdx.z;
  const int tile = blockIdx.y;
  const int sp = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // the fragment's rows g and g + 8
  const int tq = lane & 3;    // and columns 2 tq, 2 tq + 1
  const int H = a.H;
  const int h0 = tile * kTile;
  const int hi = min(a.pos[b] + 1, a.S);   // positions [0, hi), hi >= 1
  const int last = (hi - 1) / a.split;
  if (sp > last) return;
  const int nlive = last + 1;
  const int s0 = sp * a.split;
  const int s1 = min(hi, s0 + a.split);
  const int nchunks = (s1 - s0 + kChunk - 1) / kChunk;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);           // [3][kTile][kRow]
  bf16* stages = qs + 3 * kTile * kRow;               // [2][kStage]
  bf16* ps = stages + 2 * T::kStage;                  // [3][kTile][kPRow]
  float* red_m = reinterpret_cast<float*>(ps + 3 * kTile * kPRow);   // [kWarps][kTile]
  float* red_l = red_m + kWarps * kTile;
  int* flag = reinterpret_cast<int*>(red_l + kWarps * kTile);

  const bf16* ckv = static_cast<const bf16*>(a.ckv) + (long long)b * a.S * R;
  const bf16* kpe = static_cast<const bf16*>(a.kpe) + (long long)b * a.S * Dr;
  auto stage = [&](bf16* dst, int c0, int n) {
    for (int piece = tid; piece < kChunk * T::kUnits; piece += kThreads) {
      const int j = piece / T::kUnits;
      const int u = piece % T::kUnits;
      bf16* d = dst + j * kRow + u * 8;
      if (j < n)
        cp_async16(d, u < T::kUnitsR ? ckv + (long long)(c0 + j) * R + u * 8
                                     : kpe + (long long)(c0 + j) * Dr + (u - T::kUnitsR) * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };
  stage(stages, s0, min(kChunk, s1 - s0));

  // the tile's queries [q_abs | q_pe], split into three bf16 pieces; a
  // padded head's are zeros
  const float* qa = a.q_abs + (long long)b * H * R;
  const float* qp = a.q_pe + (long long)b * H * Dr;
  for (int e = tid; e < kTile * T::kD / 4; e += kThreads) {
    const int r = e / (T::kD / 4);
    const int c = (e % (T::kD / 4)) * 4;
    const int h = h0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h < H)
      x = c < R ? *reinterpret_cast<const float4*>(qa + h * R + c)
                : *reinterpret_cast<const float4*>(qp + h * Dr + c - R);
    unsigned p0[3], p1[3], p2[3], p3[3];
    split3(x.x, p0);
    split3(x.y, p1);
    split3(x.z, p2);
    split3(x.w, p3);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint2*>(qs + (k * kTile + r) * kRow + c) =
          make_uint2(pack(p0[k], p1[k]), pack(p2[k], p3[k]));
  }

  // the running max of rows g and g + 8 (the same in every warp), this
  // thread's share of their sums, and the warp's accumulator columns
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[T::kNT][4];
#pragma unroll
  for (int t = 0; t < T::kNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  const int col0 = warp * T::kCols;
  // ldmatrix row addresses: an A tile (rows 0-15 of two 8-deep halves) and
  // a K tile (positions 0-15 of two 8-deep halves, B of two 8-position
  // tiles); the trans V tile is read as the A tile's layout
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = s0 + c * kChunk;
    const int n = min(kChunk, s1 - c0);
    cp_async_wait_all();
    __syncthreads();   // chunk c (and the queries) in; everyone done with chunk c - 1
    if (c + 1 < nchunks)
      stage(stages + ((c + 1) & 1) * T::kStage, c0 + kChunk, min(kChunk, s1 - c0 - kChunk));
    const bf16* ks = stages + (c & 1) * T::kStage;

    // 1) scores of the tile's heads at positions 16 warp + [0, 16)
    float sc[3][2][4];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int t = 0; t < 2; ++t) sc[k][t][0] = sc[k][t][1] = sc[k][t][2] = sc[k][t][3] = 0.f;
    const bf16* kw = ks + (warp * 16 + k_row) * kRow + k_col;
#pragma unroll 2
    for (int st = 0; st < T::kSteps; ++st) {
      unsigned kb[4];
      ldsm_x4(kb, kw + st * 16);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        unsigned qf[4];
        ldsm_x4(qf, qs + (k * kTile + a_row) * kRow + st * 16 + a_col);
        mma(sc[k][0], qf, kb[0], kb[1]);
        mma(sc[k][1], qf, kb[2], kb[3]);
      }
    }
    float x[2][4];
    float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = warp * 16 + t * 8 + 2 * tq + (i & 1);
        const float s = sc[0][t][i] + (sc[1][t][i] + sc[2][t][i]);
        x[t][i] = j < n ? s * a.scale : -INFINITY;
        cmax[i >> 1] = fmaxf(cmax[i >> 1], x[t][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
      cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
      if (tq == 0) red_m[warp * kTile + g + 8 * r] = cmax[r];
    }
    __syncthreads();   // every warp's chunk max

    // 2) the chunk's max (finite: its first position is live), the
    //    correction, and the probabilities' pieces to shared memory
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mc = red_m[g + 8 * r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mc = fmaxf(mc, red_m[w * kTile + g + 8 * r]);
      const float m_new = fmaxf(m_run[r], mc);
      corr[r] = expf(m_run[r] - m_new);   // 0 at the first chunk
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      unsigned pc[4][3];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(x[t][i] - m_run[i >> 1]);
        psum[i >> 1] += p;
        split3(p, pc[i]);
      }
      const int j = warp * 16 + t * 8 + 2 * tq;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        *reinterpret_cast<unsigned*>(ps + (k * kTile + g) * kPRow + j) = pack(pc[0][k], pc[1][k]);
        *reinterpret_cast<unsigned*>(ps + (k * kTile + g + 8) * kPRow + j) =
            pack(pc[2][k], pc[3][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
#pragma unroll
    for (int t = 0; t < T::kNT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] *= corr[i >> 1];
    }
    __syncthreads();   // every warp's probabilities

    // 3) acc += P . ckv over the chunk, 16 positions a step
#pragma unroll
    for (int st = 0; st < kChunk / 16; ++st) {
      unsigned pf[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k) ldsm_x4(pf[k], ps + (k * kTile + a_row) * kPRow + st * 16 + a_col);
      const bf16* vr = ks + (st * 16 + a_row) * kRow + col0;
      if constexpr (T::kNT % 2 == 0) {
#pragma unroll
        for (int t = 0; t < T::kNT; t += 2) {
          unsigned vb[4];
          ldsm_x4_t(vb, vr + t * 8 + a_col);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            mma(acc[t], pf[k], vb[0], vb[1]);
            mma(acc[t + 1], pf[k], vb[2], vb[3]);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < T::kNT; ++t) {
          unsigned vb[2];
          ldsm_x2_t(vb, vr + t * 8);
#pragma unroll
          for (int k = 0; k < 3; ++k) mma(acc[t], pf[k], vb[0], vb[1]);
        }
      }
    }
  }

  // the sums of rows g and g + 8: the quad's shares, then the warps'
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (tq == 0) red_l[warp * kTile + g + 8 * r] = l_run[r];
  }
  __syncthreads();
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_tot[r] = red_l[g + 8 * r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l_tot[r] += red_l[w * kTile + g + 8 * r];
  }

  const long long obase = (long long)b * H * R;
  const long long pbase = (long long)b * a.nsplit;   // this row's first split slot
  auto pm = [&](int s) { return (pbase + s) * H; };
  auto pa = [&](int s) { return (pbase + s) * H * R; };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = h0 + g + 8 * r;
    if (h >= H) continue;
    const float inv = 1.f / fmaxf(l_tot[r], 1e-20f);
#pragma unroll
    for (int t = 0; t < T::kNT; ++t) {
      const int col = col0 + t * 8 + 2 * tq;
      if (nlive == 1)
        *reinterpret_cast<float2*>(a.out + obase + h * R + col) =
            make_float2(acc[t][2 * r] * inv, acc[t][2 * r + 1] * inv);
      else
        *reinterpret_cast<float2*>(a.part_acc + pa(sp) + h * R + col) =
            make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
    }
    if (nlive > 1 && warp == 0 && tq == 0) {
      a.part_m[pm(sp) + h] = m_run[r];
      a.part_l[pm(sp) + h] = l_tot[r];
    }
  }
  if (nlive == 1) return;
  const int crow = b * ((H + kTile - 1) / kTile) + tile;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.count + crow, 1) == nlive - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last live split: every split's (m, l) of the tile's heads into
  // shared memory at once (queries, stages and probabilities are free), a
  // weight a (split, head), exp(m_s - max) / L, then every latent element
  // of the tile's heads summed over the splits in split order, each
  // thread's kVecs float4s a split at a time, so their loads are in flight
  // together
  const int nh = min(kTile, H - h0);
  float* pm_s = reinterpret_cast<float*>(smem);   // [nlive][kTile]
  float* pl_s = pm_s + nlive * kTile;
  float* wt = pl_s + nlive * kTile;
  for (int i = tid; i < nlive * kTile; i += kThreads) {
    const int s = i / kTile, r = i % kTile;
    if (r < nh) {
      pm_s[i] = __ldcg(a.part_m + pm(s) + h0 + r);
      pl_s[i] = __ldcg(a.part_l + pm(s) + h0 + r);
    }
  }
  __syncthreads();
  for (int r = tid; r < nh; r += kThreads) {
    float mx = -INFINITY;
    for (int s = 0; s < nlive; ++s) mx = fmaxf(mx, pm_s[s * kTile + r]);
    float l = 0.f;
    for (int s = 0; s < nlive; ++s) {
      const float w = expf(pm_s[s * kTile + r] - mx);
      wt[s * kTile + r] = w;
      l += pl_s[s * kTile + r] * w;
    }
    const float inv = 1.f / fmaxf(l, 1e-20f);
    for (int s = 0; s < nlive; ++s) wt[s * kTile + r] *= inv;
  }
  __syncthreads();
  constexpr int kVecs = (kTile * R / 4 + kThreads - 1) / kThreads;   // float4s a thread
  const long long tbase = (long long)h0 * R;   // the tile's first element of a row
  float4 o[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nlive; ++s) {
    const float* src = a.part_acc + pa(s) + tbase;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int e = (tid + i * kThreads) * 4;
      if (e < nh * R) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + e));
        const float w = wt[s * kTile + e / R];
        o[i].x += v.x * w;
        o[i].y += v.y * w;
        o[i].z += v.z * w;
        o[i].w += v.w * w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int e = (tid + i * kThreads) * 4;
    if (e < nh * R) *reinterpret_cast<float4*>(a.out + obase + tbase + e) = o[i];
  }
  if (tid == 0) a.count[crow] = 0;
}

template <int R, int Dr>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.split % kChunk) return (int)cudaErrorInvalidValue;
  // the combine's (m, l) and weights [3][nsplit][kTile] live in the
  // block's work space
  if ((long long)a.nsplit * kTile * 12 > work_bytes<R, Dr>()) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.nsplit, (a.H + kTile - 1) / kTile, B);
  constexpr int smem = smem_bytes<R, Dr>();
  return launch_kernel<mla_tc_kernel<R, Dr>>(kThreads, smem, smem, grid, stream, a);
}

}  // namespace tc

// ---- the fp32 cache: fp32 products on the CUDA cores --------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;    // positions a step: one a lane
constexpr int kVec = 4;       // floats a 16-byte piece

// V consecutive fp32 values, 16 bytes at a time.
template <int V>
__device__ __forceinline__ void load_f(const float* p, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    f[i] = u.x;
    f[i + 1] = u.y;
    f[i + 2] = u.z;
    f[i + 3] = u.w;
  }
}

// The geometry of one (R, Dr) instantiation.
template <int R, int Dr>
struct Geo {
  static constexpr int kD = R + Dr;                   // key width: [ckv | kpe]
  static constexpr int kUnitsR = R / kVec;            // pieces of a ckv row
  static constexpr int kUnits = kD / kVec;            // pieces of a key row
  // a staged row's stride in elements: an odd number of pieces
  static constexpr int kRow = kUnits % 2 ? kD : kD + kVec;
  static constexpr int kStage = kChunk * kRow;        // elements of one chunk
  // P . ckv: kLanesR threads cover a latent row, kGroups head groups
  static constexpr int kLanesR = R / kVec;
  static constexpr int kGroups = kThreads / kLanesR;
  static constexpr int kSlotsV = (kMaxH + kGroups - 1) / kGroups;   // heads a thread
  static constexpr int kSlotsS = kMaxH / kWarps;                     // heads a warp
  static_assert(R % kVec == 0 && Dr % kVec == 0 && kThreads % kLanesR == 0, "geometry");
};

template <int R, int Dr>
__host__ __device__ constexpr int smem_bytes(int H) {
  using T = Geo<R, Dr>;
  return H * T::kD * 4 + 2 * T::kStage * 4 + (H * kChunk + 3 * H + 4) * 4;
}

template <int R, int Dr>
__global__ void __launch_bounds__(kThreads) mla_kernel(Args a) {
  using T = Geo<R, Dr>;
  constexpr int D = T::kD;
  constexpr int V = kVec;
  const int b = blockIdx.z;
  const int sp = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = a.H;
  const int hi = min(a.pos[b] + 1, a.S);   // positions [0, hi), hi >= 1
  const int last = (hi - 1) / a.split;
  if (sp > last) return;
  const int nlive = last + 1;
  const int s0 = sp * a.split;
  const int s1 = min(hi, s0 + a.split);
  const int nchunks = (s1 - s0 + kChunk - 1) / kChunk;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                         // [H][D]
  float* stages = qs + H * D;                                         // [2][kStage]
  float* pr = stages + 2 * T::kStage;                                 // [H][kChunk]
  float* corr_s = pr + H * kChunk;                                    // [H]
  float* m_s = corr_s + H;
  float* l_s = m_s + H;
  int* flag = reinterpret_cast<int*>(l_s + H);

  const float* ckv = static_cast<const float*>(a.ckv) + (long long)b * a.S * R;
  const float* kpe = static_cast<const float*>(a.kpe) + (long long)b * a.S * Dr;
  auto stage = [&](float* dst, int c0, int n) {
    for (int piece = tid; piece < n * T::kUnits; piece += kThreads) {
      const int j = piece / T::kUnits;
      const int u = piece % T::kUnits;
      const float* src = u < T::kUnitsR ? ckv + (long long)(c0 + j) * R + u * V
                                        : kpe + (long long)(c0 + j) * Dr + (u - T::kUnitsR) * V;
      cp_async16(dst + j * T::kRow + u * V, src);
    }
    cp_async_commit();
  };
  stage(stages, s0, min(kChunk, s1 - s0));

  // the queries, fp32, [q_abs | q_pe] a head
  const float* qa = a.q_abs + (long long)b * H * R;
  const float* qp = a.q_pe + (long long)b * H * Dr;
  for (int e = tid; e < H * D / 4; e += kThreads) {
    const int h = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    const float4 x = c < R ? *reinterpret_cast<const float4*>(qa + h * R + c)
                           : *reinterpret_cast<const float4*>(qp + h * Dr + c - R);
    *reinterpret_cast<float4*>(qs + h * D + c) = x;
  }

  // this warp's heads' running (max, sum): warp + kWarps * i
  float m_run[T::kSlotsS], l_run[T::kSlotsS];
#pragma unroll
  for (int i = 0; i < T::kSlotsS; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  // this thread's latent columns [cr, cr + V) of heads hg + kGroups * i
  const int cr = (tid % T::kLanesR) * V;
  const int hg = tid / T::kLanesR;
  float acc[T::kSlotsV][V];
#pragma unroll
  for (int i = 0; i < T::kSlotsV; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  }

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = s0 + c * kChunk;
    const int n = min(kChunk, s1 - c0);
    cp_async_wait_all();
    __syncthreads();   // chunk c (and the queries) in; everyone done with chunk c - 1
    if (c + 1 < nchunks)
      stage(stages + ((c + 1) & 1) * T::kStage, c0 + kChunk, min(kChunk, s1 - c0 - kChunk));
    const float* ks = stages + (c & 1) * T::kStage;

    // 1) scores of position `lane` for this warp's heads, then their softmax
    {
      float s[T::kSlotsS];
#pragma unroll
      for (int i = 0; i < T::kSlotsS; ++i) s[i] = 0.f;
      const float* kr = ks + lane * T::kRow;
#pragma unroll 4
      for (int u = 0; u < T::kUnits; ++u) {
        float kf[V];
        load_f<V>(kr + u * V, kf);
#pragma unroll
        for (int i = 0; i < T::kSlotsS; ++i) {
          const int h = warp + kWarps * i;
          if (h < H) {
            float qf[V];
            load_f<V>(qs + h * D + u * V, qf);
            float t = 0.f;
#pragma unroll
            for (int e = 0; e < V; ++e) t += qf[e] * kf[e];
            s[i] += t;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < T::kSlotsS; ++i) {
        const int h = warp + kWarps * i;
        if (h < H) {
          const float x = lane < n ? s[i] * a.scale : -INFINITY;
          const float m_new = fmaxf(m_run[i], warp_max(x));   // finite: lane 0 is live
          const float p = expf(x - m_new);
          const float corr = expf(m_run[i] - m_new);
          l_run[i] = l_run[i] * corr + warp_sum(p);
          m_run[i] = m_new;
          pr[h * kChunk + lane] = p;
          if (lane == 0) corr_s[h] = corr;
        }
      }
    }
    __syncthreads();   // every head's probabilities and correction

    // 2) acc = acc * corr + P . ckv over the chunk's rows
#pragma unroll
    for (int i = 0; i < T::kSlotsV; ++i) {
      const int h = hg + T::kGroups * i;
      if (h < H) {
        const float cf = corr_s[h];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] *= cf;
      }
    }
    for (int j = 0; j < n; ++j) {
      float vf[V];
      load_f<V>(ks + j * T::kRow + cr, vf);
#pragma unroll
      for (int i = 0; i < T::kSlotsV; ++i) {
        const int h = hg + T::kGroups * i;
        if (h < H) {
          const float p = pr[h * kChunk + j];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] += p * vf[e];
        }
      }
    }
  }

  // the running (max, sum) of every head, for the output or the combine
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < T::kSlotsS; ++i) {
      const int h = warp + kWarps * i;
      if (h < H) {
        m_s[h] = m_run[i];
        l_s[h] = l_run[i];
      }
    }
  }
  __syncthreads();

  const long long obase = (long long)b * H * R;
  const long long pbase = (long long)b * a.nsplit;   // this row's first split slot
  auto pm = [&](int s) { return (pbase + s) * H; };
  auto pa = [&](int s) { return (pbase + s) * H * R; };
#pragma unroll
  for (int i = 0; i < T::kSlotsV; ++i) {
    const int h = hg + T::kGroups * i;
    if (h < H) {
      const float inv = 1.f / fmaxf(l_s[h], 1e-20f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (nlive == 1)
          a.out[obase + h * R + cr + e] = acc[i][e] * inv;
        else
          a.part_acc[pa(sp) + h * R + cr + e] = acc[i][e];
      }
    }
  }
  if (nlive == 1) return;
  for (int h = tid; h < H; h += kThreads) {
    a.part_m[pm(sp) + h] = m_s[h];
    a.part_l[pm(sp) + h] = l_s[h];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.count + b, 1) == nlive - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last live split: a weight a (split, head), exp(m_s - max) / L in
  // shared memory (the stages are free), then every latent element summed
  // over the splits in split order, 16 bytes a thread at a time: the
  // block reads each split's H * R partial once
  float* wt = reinterpret_cast<float*>(smem);   // [nlive][H]
  for (int h = tid; h < H; h += kThreads) {
    float mx = -INFINITY;
    for (int s = 0; s < nlive; ++s) mx = fmaxf(mx, __ldcg(a.part_m + pm(s) + h));
    float l = 0.f;
    for (int s = 0; s < nlive; ++s) {
      const float w = expf(__ldcg(a.part_m + pm(s) + h) - mx);
      wt[s * H + h] = w;
      l += __ldcg(a.part_l + pm(s) + h) * w;
    }
    const float inv = 1.f / fmaxf(l, 1e-20f);
    for (int s = 0; s < nlive; ++s) wt[s * H + h] *= inv;
  }
  __syncthreads();
  for (int e = tid * 4; e < H * R; e += kThreads * 4) {
    const int h = e / R;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nlive; ++s) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(a.part_acc + pa(s) + e));
      const float w = wt[s * H + h];
      o.x += x.x * w;
      o.y += x.y * w;
      o.z += x.z * w;
      o.w += x.w * w;
    }
    *reinterpret_cast<float4*>(a.out + obase + e) = o;
  }
  if (tid == 0) a.count[b] = 0;
}

template <int R, int Dr>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.split % kChunk) return (int)cudaErrorInvalidValue;
  // the combine's weights [nsplit][H] live in the block's shared memory
  if ((long long)a.nsplit * a.H * 4 > smem_bytes<R, Dr>(a.H)) return (int)cudaErrorInvalidValue;
  return launch_kernel<mla_kernel<R, Dr>>(kThreads, smem_bytes<R, Dr>(a.H),
                                          smem_bytes<R, Dr>(kMaxH), dim3(a.nsplit, 1, B), stream,
                                          a);
}

}  // namespace simt

template <bool kBf16>
int launch_shape(const Args& a, int B, int R, int Dr, cudaStream_t stream) {
  if (R == 256 && Dr == 32)
    return kBf16 ? tc::launch<256, 32>(a, B, stream) : simt::launch<256, 32>(a, B, stream);
  if (R == 32 && Dr == 16)
    return kBf16 ? tc::launch<32, 16>(a, B, stream) : simt::launch<32, 16>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One grid launch.  part_m / part_l hold B * nsplit * H floats and
// part_acc that times R; none is read by a row with one live split.
// Positions past S are never read: nsplit * split must cover S.  count
// holds B * ceil(H / 16) counters for a bf16 cache, B for fp32.
extern "C" int mla_decode(const float* q_abs, const float* q_pe, const void* ckv,
                          const void* kpe, int kv_bf16, const int* pos, float* out,
                          float* part_m, float* part_l, float* part_acc, int* count, int B,
                          int S, int H, int R, int Dr, int split, int nsplit, float scale,
                          void* stream) {
  if (H < 1 || H > kMaxH || S < 1 || split < 1 || nsplit < 1 ||
      (long long)split * nsplit < S || nsplit > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{q_abs, q_pe, ckv, kpe, pos, out, part_m, part_l, part_acc, count,
               S,     H,    split, nsplit, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bf16) return launch_shape<true>(a, B, R, Dr, s);
  return launch_shape<false>(a, B, R, Dr, s);
}
