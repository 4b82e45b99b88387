// Masked centroid inner products: the IVF coarse probe's scores, reached
// through kernels/ops.py centroid_probe (then torch.topk picks the nprobe
// clusters), as the reference reaches its kernel through ops.centroid_probe.
//
// Replaces: src/repro/kernels/centroid_probe.py, centroid_scores (Pallas
//           body _kernel).
//
// Bound on an H100: bytes.  The work is one pass over the valid centroid
// rows (Nc * d fp32) and 2 * B flops per value; at the serve shape (B=4,
// d=768, Nc=1024) that is 3.1 MB and 6.3 MFLOP, 1.5 flop per byte read.
// The TPU kernel keeps the queries in VMEM and streams centroid tiles
// through the MXU.  Here the whole problem is a few microseconds of
// memory traffic, so the design puts every row's bytes in flight at once,
// spread over the card, behind as few dependent round trips as it can:
//   * the grid is sized by the wrapper from the SM count (kernels/
//     centroid_probe.py _plan): one block per SM, or a few where a block
//     would take more than 8 warps x kRows rows, each block a contiguous
//     share of the rows (7-8 at Nc = 1024, 15-16 at Nc = 4096 over 264
//     blocks), so every SM has rows and each block stages the queries once;
//   * each warp takes up to kRows centroid rows; its lanes issue all their
//     16-byte loads of a row segment (kSlices float4 a lane: 1024 floats,
//     a whole row at d <= 1024) for every one of its rows before the first
//     FMA, and keep them in registers for every query;
//   * the queries are copied into shared memory with cp.async a segment
//     at a time (as many as fit 48 KB, in turn when B is larger), issued
//     before the row loads wait on the valid flags, so the block waits one
//     round trip for both; they are read as float4 at the lane's own
//     index and summed in exact groups of 8, 4, 2 and 1 queries
//     (templates; no query is repeated), each group's sums reduced with
//     shuffles and written by one lane each;
//   * fp32 FMA, no TF32, so the cut at nprobe does not move; an invalid
//     centroid's row is never read, its scores are -inf;
//   * a d that is not a multiple of 4, or a query or centroid pointer off
//     a 16-byte boundary, takes the same code with 4-byte loads (segments
//     of 256 floats); a d past one segment sums segment by segment, each
//     segment's sum added to the output by the lane that wrote it.
//
// Layouts: q [B, d] fp32; centroids [Nc, d] fp32; valid [Nc] one byte each
// (null = every centroid valid); out [B, Nc] fp32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 2;                   // centroid rows a warp takes
constexpr int kSlices = 8;                 // vectors a lane holds of a row segment
constexpr int kSegV = 32 * kSlices;        // vectors of a row segment
constexpr int kQueryBytes = 48 * 1024;     // shared memory for staged query segments
constexpr int kMaxThreads = 256;

template <int W> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

// Copy one W-float vector into shared memory asynchronously.
__device__ __forceinline__ void cp_async(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ float dot(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ float dot(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename VT> __device__ __forceinline__ VT zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One group of QG staged queries (qs: the group's first, kSegV vectors a
// query) against the warp's rows x, over the nv vectors of this segment;
// query q0 + j of row rows[r] goes to out, first segment stored, later
// ones added.
template <int QG, typename VT>
__device__ __forceinline__ void group(const VT (&x)[kRows][kSlices], const VT* qs, int nv,
                                      const bool (&live)[kRows], const int (&row)[kRows],
                                      float* __restrict__ out, int Nc, int q0, bool first) {
  const int lane = threadIdx.x & 31;
  float acc[kRows][QG];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < QG; ++j) acc[r][j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    if (k * 32 >= nv) break;               // warp-uniform: the segment's end
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      const VT qv = qs[j * kSegV + k * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][j] = dot(x[r][k], qv, acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      const float s = warp_sum(acc[r][j]);
      if (lane == r * QG + j && row[r] >= 0) {
        float* o = out + (long long)(q0 + j) * Nc + row[r];
        *o = !live[r] ? -INFINITY : first ? s : *o + s;
      }
    }
  }
}

// W floats a load (4: float4, 1: the scalar path); QG0 the largest query
// group (8, 4, 2 or 1, at most B); qb queries staged at once.  Block b
// takes rows [b * Nc / gridDim.x, (b + 1) * Nc / gridDim.x), warp w the
// rpw rows from w * rpw of them (rpw = that count over the warps, at most
// kRows by the wrapper's plan).
template <int W, int QG0>
__global__ void __launch_bounds__(kMaxThreads)
centroid_kernel(const float* __restrict__ q, const float* __restrict__ cent,
                const uint8_t* __restrict__ valid, float* __restrict__ out, int B, int d,
                int Nc, int qb) {
  using VT = typename Vec<W>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  VT* qs = reinterpret_cast<VT*>(smem);    // [qb][kSegV]
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int lo = (int)((long long)blockIdx.x * Nc / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * Nc / gridDim.x);
  const int rpw = (hi - lo + warps - 1) / warps;
  const int dv = d / W;                    // vectors of a row
  const VT* qv = reinterpret_cast<const VT*>(q);
  int row[kRows];                          // -1: no row
  bool live[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int c = lo + (threadIdx.x >> 5) * rpw + r;
    row[r] = r < rpw && c < hi ? c : -1;
    live[r] = row[r] >= 0 && (valid == nullptr || valid[c] != 0);
  }
  // copy queries [q0, q0 + nq) of segment [v0, v0 + nv) into qs (zeros
  // up to the last 32-vector slice the groups read)
  auto stage = [&](int q0, int nq, int v0, int nv, int nv32) {
    for (int e = threadIdx.x; e < nq * nv32; e += blockDim.x) {
      const int i = e / nv32;
      const int v = e - i * nv32;
      if (v < nv)
        cp_async(qs + i * kSegV + v, qv + (long long)(q0 + i) * dv + v0 + v);
      else
        qs[i * kSegV + v] = zero<VT>();
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int v0 = 0; v0 < dv; v0 += kSegV) {
    const int nv = min(kSegV, dv - v0);
    const int nv32 = (nv + 31) & ~31;      // the vectors the groups read
    if (v0 > 0) __syncthreads();           // the previous segment's stage is consumed
    stage(0, min(qb, B), v0, nv, nv32);
    // every load of the segment's rows in flight before the first FMA;
    // they serve every staged chunk of queries
    VT x[kRows][kSlices];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const VT* src = reinterpret_cast<const VT*>(cent + (long long)(live[r] ? row[r] : 0) * d);
#pragma unroll
      for (int k = 0; k < kSlices; ++k) {
        const int v = k * 32 + lane;
        x[r][k] = live[r] && v < nv ? src[v0 + v] : zero<VT>();
      }
    }
    for (int q0 = 0; q0 < B; q0 += qb) {
      const int nq = min(qb, B - q0);
      if (q0 > 0) {
        __syncthreads();                   // the previous chunk is consumed
        stage(q0, nq, v0, nv, nv32);
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      const bool first = v0 == 0;
      int g = 0;
      for (; g + QG0 <= nq; g += QG0)
        group<QG0>(x, qs + g * kSegV, nv, live, row, out, Nc, q0 + g, first);
      if constexpr (QG0 > 4) {
        if (g + 4 <= nq) {
          group<4>(x, qs + g * kSegV, nv, live, row, out, Nc, q0 + g, first);
          g += 4;
        }
      }
      if constexpr (QG0 > 2) {
        if (g + 2 <= nq) {
          group<2>(x, qs + g * kSegV, nv, live, row, out, Nc, q0 + g, first);
          g += 2;
        }
      }
      if constexpr (QG0 > 1) {
        if (g < nq) group<1>(x, qs + g * kSegV, nv, live, row, out, Nc, q0 + g, first);
      }
    }
  }
}

template <int W>
int launch(int group, const float* q, const float* c, const uint8_t* valid, float* out, int B,
           int d, int Nc, int qb, dim3 grid, int threads, int smem, cudaStream_t s) {
  switch (group) {
    case 1: centroid_kernel<W, 1><<<grid, threads, smem, s>>>(q, c, valid, out, B, d, Nc, qb); break;
    case 2: centroid_kernel<W, 2><<<grid, threads, smem, s>>>(q, c, valid, out, B, d, Nc, qb); break;
    case 4: centroid_kernel<W, 4><<<grid, threads, smem, s>>>(q, c, valid, out, B, d, Nc, qb); break;
    case 8: centroid_kernel<W, 8><<<grid, threads, smem, s>>>(q, c, valid, out, B, d, Nc, qb); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper's plan (kernels/centroid_probe.py _plan): vec (16-byte loads;
// d % 4 == 0 and both pointers 16-byte aligned), the largest query group,
// warps a block, blocks (each at most warps * kRows rows), and queries
// staged at once.
extern "C" int centroid_scores(const float* q, const float* centroids, const uint8_t* valid,
                               float* out, int B, int d, int Nc, int vec, int group, int warps,
                               int blocks, int qb, void* stream) {
  const int W = vec ? 4 : 1;
  const long long stage = (long long)qb * kSegV * W * 4;
  if (d < 1 || B < 0 || Nc < 0 || warps < 1 || warps * 32 > kMaxThreads || blocks < 1 ||
      (blocks > Nc && Nc > 0) || ((long long)Nc + blocks - 1) / blocks > warps * kRows ||
      qb < 1 || stage > kQueryBytes ||
      (vec && (d % 4 || ((uintptr_t)q | (uintptr_t)centroids) % 16)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Nc == 0) return 0;
  if (group > B) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<4>(group, q, centroids, valid, out, B, d, Nc, qb, grid, warps * 32,
                         (int)stage, s)
             : launch<1>(group, q, centroids, valid, out, B, d, Nc, qb, grid, warps * 32,
                         (int)stage, s);
}
