// Candidate ways to dequantize an int8 K/V value for flash_decode_quant
// (decode_attn.cuh), each exact: bf16(fp32(x) * s) widened to fp32, x in
// [-127, 127], s a bf16 scale, as the reference's dequantize_heads.
// Not a kernel of the port: dequant_bench.py beside it builds this file,
// checks every candidate on every int8 value against dequantize_ref and
// times each in a loop shaped like the decode kernel's score loop (8
// values a thread from a 16-byte-aligned shared row, 2 query rows, 2 fp32
// FMAs a value: gemma2's G = 2).
//
//   0  the parent's: sign-extend, I2F, FMUL, F2F to bf16, widen
//   1  a magic float (a byte permute: 2^23 + x + 128), one FFMA with
//      -(2^23 + 128) s (exact: 24 significant bits) giving x s exactly,
//      then round to bf16 with integer operations
//   2  the same exact product, two rounded to a bf16 pair by one
//      cvt.rn.bf16x2.f32, then widened
//   3  x exact in fp32 (magic float minus 2^23 + 128), two packed into a
//      bf16 pair by a byte permute, one fma.rn.bf16x2 by (s, s), widened
//   4  the same exact product rounded to 8 significant bits by Veltkamp's
//      split, c = p (2^16 + 1), p - (c - p)... as c - (c - p), in fp32;
//      equal to round-to-nearest-even on this domain for s below 4e31

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;          // rows of 128 int8 values in shared memory
constexpr int kLanes = 16;         // 8 values a lane: 16 lanes a row

__device__ __forceinline__ float widen_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float widen_hi(unsigned v) { return __uint_as_float(v & 0xFFFF0000u); }

template <int kVar>
__device__ __forceinline__ void dq8(uint2 u, float s, float (&f)[8]) {
  const unsigned w[2] = {u.x, u.y};
  if constexpr (kVar == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int x = (int)(signed char)(w[i / 4] >> (8 * (i % 4)));
      f[i] = __bfloat162float(__float2bfloat16_rn((float)x * s));
    }
  } else if constexpr (kVar == 1 || kVar == 2 || kVar == 4) {
    const unsigned b[2] = {w[0] ^ 0x80808080u, w[1] ^ 0x80808080u};
    const float nc = -8388736.f * s;
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i] = fmaf(__uint_as_float(__byte_perm(b[i / 4], 0x4B000000u, 0x7440 | (i % 4))), s, nc);
    if constexpr (kVar == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned v = __float_as_uint(p[i]);
        f[i] = __uint_as_float((v + 0x7FFFu + ((v >> 16) & 1u)) & 0xFFFF0000u);
      }
    } else if constexpr (kVar == 2) {
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(p[i], p[i + 1]);
        const unsigned v = *reinterpret_cast<const unsigned*>(&h);
        f[i] = widen_lo(v);
        f[i + 1] = widen_hi(v);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = __fmul_rn(p[i], 65537.f);
        f[i] = __fsub_rn(c, __fsub_rn(c, p[i]));
      }
    }
  } else {
    const unsigned b[2] = {w[0] ^ 0x80808080u, w[1] ^ 0x80808080u};
    const __nv_bfloat16 sb = __float2bfloat16_rn(s);   // s is a bf16 value: exact
    const unsigned s2 = (unsigned)__bfloat16_as_ushort(sb) * 0x10001u;
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const float x0 = __uint_as_float(__byte_perm(b[i / 4], 0x4B000000u, 0x7440 | (i % 4))) - 8388736.f;
      const float x1 =
          __uint_as_float(__byte_perm(b[i / 4], 0x4B000000u, 0x7440 | ((i + 1) % 4))) - 8388736.f;
      const unsigned xx = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
      unsigned v;
      asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(v) : "r"(xx), "r"(s2), "r"(0x80008000u));
      f[i] = widen_lo(v);
      f[i + 1] = widen_hi(v);
    }
  }
}

// out[k * 256 + j] = candidate(x[j], scales[k]); a thread does 8 values
template <int kVar>
__global__ void values_kernel(const uint2* __restrict__ x, const float* __restrict__ scales,
                              int ns, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ns * 32) return;
  const int k = t / 32, j = t % 32;
  float f[8];
  dq8<kVar>(x[j], scales[k], f);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[(long long)k * 256 + j * 8 + i] = f[i];
}

// The score loop's shape: each thread dequantizes 8 values of a staged
// row and takes them into two fp32 dot products, iters rows a thread
template <int kVar>
__global__ void __launch_bounds__(kThreads) bench_kernel(const uint2* __restrict__ rows,
                                                         const float* __restrict__ scales,
                                                         int iters, float* __restrict__ sink) {
  __shared__ uint2 sm[kRows * kLanes];
  __shared__ float ss[kRows];
  for (int i = threadIdx.x; i < kRows * kLanes; i += kThreads) sm[i] = rows[i];
  if (threadIdx.x < kRows) ss[threadIdx.x] = scales[threadIdx.x];
  __syncthreads();
  const int sub = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  float q[2][8], acc[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) q[g][e] = 0.001f * (g * 8 + e + 1);
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
    // a row no unrolled body repeats, so nothing is hoisted out of the loop
    const int r = (slot + 8 * it + (it >> 3)) % kRows;
    float f[8];
    dq8<kVar>(sm[r * kLanes + sub], ss[r], f);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) t += q[g][e] * f[e];
      acc[g] += t;
    }
  }
  sink[blockIdx.x * kThreads + threadIdx.x] = acc[0] + acc[1];
}

template <int kVar>
int run(int what, const void* x, const float* scales, int n, float* out, cudaStream_t s) {
  if (what == 0) {
    values_kernel<kVar><<<(n * 32 + 255) / 256, 256, 0, s>>>(static_cast<const uint2*>(x), scales,
                                                             n, out);
  } else {
    bench_kernel<kVar><<<what, kThreads, 0, s>>>(static_cast<const uint2*>(x), scales, n, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// what == 0: out[k * 256 + j] = candidate kVar on the 256 int8 values x
// and the n scales; what > 0: the timing loop on `what` blocks, n rows a
// thread, over x [64 rows x 128] and 64 scales, into out [what * 128].
extern "C" int dequant_bench(int variant, int what, const void* x, const float* scales, int n,
                             float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return run<0>(what, x, scales, n, out, s);
    case 1: return run<1>(what, x, scales, n, out, s);
    case 2: return run<2>(what, x, scales, n, out, s);
    case 3: return run<3>(what, x, scales, n, out, s);
    case 4: return run<4>(what, x, scales, n, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
