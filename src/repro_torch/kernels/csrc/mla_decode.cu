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
// Bound on an H100: operations.  Every head shares the one latent row a
// position (one "kv head" with G = H), so a position's R + Dr key values
// and R value values are read once for all H heads, and each is used H
// times: at minicpm3's H = 40, R = 256, Dr = 32 a step does 2 H (2 R + Dr)
// = 43,520 fp32 flops a position against (R + Dr) * 2 bytes read in
// bf16, 76 flops a byte, past the fp32 rate's 20 (67 TFLOP/s over 3.35
// TB/s).  The reference computes in fp32, so the products stay fp32 on
// the CUDA cores (tensor cores would round q or P).  The design keeps
// every intermediate on chip and reads each position once:
//   * one grid of (split, b) blocks of 256 threads; a block holds all H
//     heads' queries ([q_abs | q_pe], fp32) in shared memory and walks
//     its split's positions in chunks of 32, each chunk's [ckv | kpe]
//     rows copied by 16-byte cp.async, double buffered, rows padded to
//     an odd number of 16-byte units so that 32 rows read side by side
//     fall in distinct banks;
//   * scores: warp w takes heads w, w + 8, ..., lane j position j of the
//     chunk, the queries read as broadcasts; the same warp then folds its
//     heads' 32 scores into their running (max, sum) and leaves the
//     probabilities in shared memory, so scores and softmax need no
//     barrier between them;
//   * P . ckv: each thread owns 16 bytes' worth of latent columns of a
//     few heads, so every output element has one owner and no partial
//     sums cross warps;
//   * splits of a row combine in the same launch, as the decode kernels'
//     do (decode_attn.cuh): partial (m, l, acc) to scratch, a ticket per
//     row; the last split computes one weight a (split, head) and sums the
//     H * R latent elements over the splits in split order, 16 bytes a
//     thread (a row's H * R = 10,240 elements at minicpm3's shape are ten
//     times the decode kernels' G * Dh, so each split's partial is read
//     once, and no weight is recomputed an element).
//
// Layouts: q_abs [B, H, R] and q_pe [B, H, Dr] fp32; ckv [B, S, R] and
// kpe [B, S, Dr] bf16 or fp32; pos [B] int32; out [B, H, R] fp32; scratch
// [B, nsplit, H] m and l, [B, nsplit, H, R] acc (16-byte aligned); count
// [B] int32, zero before the first launch (each launch leaves it zero).  Takes H = 1..64
// and (R, Dr) = (256, 32) (minicpm3) or (32, 16) (its reduced config),
// any S >= 1; rows 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;    // positions a step: one a lane
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

// 16 bytes of a cache row as floats.
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

// V consecutive fp32 query values in shared memory, 16 bytes at a time.
template <int V>
__device__ __forceinline__ void load_q(const float* p, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    f[i] = u.x;
    f[i + 1] = u.y;
    f[i + 2] = u.z;
    f[i + 3] = u.w;
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

// The geometry of one (KT, R, Dr) instantiation.
template <typename KT, int R, int Dr>
struct Geo {
  static constexpr int kVec = 16 / (int)sizeof(KT);   // elements a 16-byte piece
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

template <typename KT, int R, int Dr>
__host__ __device__ constexpr int smem_bytes(int H) {
  using T = Geo<KT, R, Dr>;
  return H * T::kD * 4 + 2 * T::kStage * (int)sizeof(KT) + (H * kChunk + 3 * H + 4) * 4;
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
  int* count;           // [B]
  int S, H, split, nsplit;
  float scale;
};

template <typename KT, int R, int Dr>
__global__ void __launch_bounds__(kThreads) mla_kernel(Args a) {
  using T = Geo<KT, R, Dr>;
  constexpr int D = T::kD;
  constexpr int V = T::kVec;
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
  KT* stages = reinterpret_cast<KT*>(qs + H * D);                     // [2][kStage]
  float* pr = reinterpret_cast<float*>(stages + 2 * T::kStage);       // [H][kChunk]
  float* corr_s = pr + H * kChunk;                                    // [H]
  float* m_s = corr_s + H;
  float* l_s = m_s + H;
  int* flag = reinterpret_cast<int*>(l_s + H);

  const KT* ckv = static_cast<const KT*>(a.ckv) + (long long)b * a.S * R;
  const KT* kpe = static_cast<const KT*>(a.kpe) + (long long)b * a.S * Dr;
  auto stage = [&](KT* dst, int c0, int n) {
    for (int piece = tid; piece < n * T::kUnits; piece += kThreads) {
      const int j = piece / T::kUnits;
      const int u = piece % T::kUnits;
      const KT* src = u < T::kUnitsR ? ckv + (long long)(c0 + j) * R + u * V
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
    const KT* ks = stages + (c & 1) * T::kStage;

    // 1) scores of position `lane` for this warp's heads, then their softmax
    {
      float s[T::kSlotsS];
#pragma unroll
      for (int i = 0; i < T::kSlotsS; ++i) s[i] = 0.f;
      const KT* kr = ks + lane * T::kRow;
#pragma unroll 4
      for (int u = 0; u < T::kUnits; ++u) {
        float kf[V];
        load16(kr + u * V, kf);
#pragma unroll
        for (int i = 0; i < T::kSlotsS; ++i) {
          const int h = warp + kWarps * i;
          if (h < H) {
            float qf[V];
            load_q<V>(qs + h * D + u * V, qf);
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
      load16(ks + j * T::kRow + cr, vf);
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

template <typename KT, int R, int Dr>
int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  // the combine's weights [nsplit][H] live in the block's shared memory
  if ((long long)a.nsplit * a.H * 4 > smem_bytes<KT, R, Dr>(a.H))
    return (int)cudaErrorInvalidValue;
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(mla_kernel<KT, R, Dr>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<KT, R, Dr>(kMaxH));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  mla_kernel<KT, R, Dr><<<grid, kThreads, smem_bytes<KT, R, Dr>(a.H), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_shape(const Args& a, int R, int Dr, dim3 grid, cudaStream_t stream) {
  if (R == 256 && Dr == 32) return launch<KT, 256, 32>(a, grid, stream);
  if (R == 32 && Dr == 16) return launch<KT, 32, 16>(a, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One grid launch.  part_m / part_l hold B * nsplit * H floats and
// part_acc that times R; none is read by a row with one live split.
// Positions past S are never read: nsplit * split must cover S.
extern "C" int mla_decode(const float* q_abs, const float* q_pe, const void* ckv,
                          const void* kpe, int kv_bf16, const int* pos, float* out,
                          float* part_m, float* part_l, float* part_acc, int* count, int B,
                          int S, int H, int R, int Dr, int split, int nsplit, float scale,
                          void* stream) {
  if (H < 1 || H > kMaxH || S < 1 || split < 1 || split % kChunk || nsplit < 1 ||
      (long long)split * nsplit < S || nsplit > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{q_abs, q_pe, ckv, kpe, pos, out, part_m, part_l, part_acc, count,
               S,     H,    split, nsplit, scale};
  const dim3 grid(nsplit, 1, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bf16) return launch_shape<__nv_bfloat16>(a, R, Dr, grid, s);
  return launch_shape<float>(a, R, Dr, grid, s);
}
