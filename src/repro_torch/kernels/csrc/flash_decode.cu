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
// 80, 128} (80: zamba2's shared attention, rows spread over 16 or 32
// lanes with the lanes past the row idle), any S >= 1, and an optional score softcap (gemma2's 50; a
// compile-time flag, so the uncapped kernels are the code they were).
// The kernel and its launch ladder are in dense_decode.cuh, shared with
// the int8 cache's flash_decode_quant.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_decode.cuh"

// One grid launch.  part_m / part_l hold B * KVH * nsplit * G floats and
// part_acc that times Dh; none is read by a row with one live split.
// Positions past S are never read: nsplit * split must cover S.  softcap
// > 0 caps each scaled score at softcap * tanh(s / softcap).
extern "C" int flash_decode(const void* q, int q_bf16, const void* k, const void* v,
                            int kv_bf16, const int* pos, float* out, float* part_m,
                            float* part_l, float* part_acc, int* count, int B, int S,
                            int KVH, int G, int Dh, int window, int split, int nsplit,
                            float scale, float softcap, void* stream) {
  using namespace dense_decode;
  if (const int err = check(B, S, KVH, G, split, nsplit)) return err;
  if (B == 0 || KVH == 0) return 0;
  const int ngt = (G + kMaxG - 1) / kMaxG;
  const Args a{q,     k,   v,      out,   part_m,  part_l, part_acc, count,  G,
               ngt,   split, nsplit, scale, softcap, nullptr, nullptr};
  const dim3 grid(nsplit, KVH * ngt, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, Dh, grid, pos, S, KVH,
                                                                     window, s);
  if (q_bf16) return (int)cudaErrorInvalidValue;   // bf16 q over fp32 K/V: no caller
  if (kv_bf16) return launch<float, __nv_bfloat16>(a, Dh, grid, pos, S, KVH, window, s);
  return launch<float, float>(a, Dh, grid, pos, S, KVH, window, s);
}
