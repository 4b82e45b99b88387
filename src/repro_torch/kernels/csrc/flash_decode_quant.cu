// Single-token GQA decode attention over an int8 dense KV cache: k/v
// [B, S, KVH, Dh] int8 with a bf16 scale per (position, kv-head),
// k_scale/v_scale [B, S, KVH].  Each row is dequantized as the reference's
// dequantize_heads does (the fp32 product of value and scale, rounded to
// bf16), and then out[b,h,g] = softmax_j(q . k_j / sqrt(Dh)) . v_j over
// pos[b] - window < j <= pos[b], as flash_decode.cu computes it.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode (Pallas body
//           _kernel), over the cache that the reference's
//           attn_decode_quant (src/repro/models/attention.py) dequantizes
//           whole in jnp before attending; the reference has no Pallas
//           kernel for int8 rows.
//
// Bound on an H100: bytes, as for the bf16 cache, but each K/V element is
// one byte and each row carries a 2-byte scale, so a step reads 2 * live
// * (Dh + 2) bytes per (b, kv-head) against 4 * live * Dh in bf16: gemma2's
// global layer at B 4, S 8192 moves 134.2 MB of K/V and 2.1 MB of scales.
// Dequantizing the layer's cache into a bf16 copy before attending (what
// the reference's jnp does) would read the int8 cache, write the bf16 copy
// and read it again.  So the rows are staged at one byte an element with
// the bf16 kernel's 16-byte cp.async copies (an int8 row of Dh = 32 is two
// of them) and dequantized on their way out of shared memory, eight values
// a read; the chunk's scales are fetched into registers while the chunk
// before computes (decode_attn.cuh).  Half the bytes leave the kernel
// bound by its instructions at gemma2's G = 2, where a value feeds 2 FMAs
// in q.K and 2 in P.V, so the rest is cut to what each value needs: the
// dequantizing takes a byte permute, an FFMA, half a paired
// cvt.rn.bf16x2.f32 and a shift or mask, with no conversion a value (two
// before: I2F and F2F, at a quarter of the FMA rate or less); the softmax
// step runs a query row a warp, with the softcap and the probabilities
// computed once a position; at G = 2 the scores' two butterflies share
// their shuffles and run over all the chunk's rows level by level.  Each is exact: the output is the earlier kernel's bit
// for bit.  Everything else,
// the splits and their combine in one launch, the G tiles and the
// optional softcap, is the bf16 kernel's (dense_decode.cuh).
//
// Layouts: q [B, KVH, G, Dh] bf16 or fp32; k/v int8; scales bf16; pos [B]
// int32; out [B, KVH, G, Dh] fp32; scratch and counters as flash_decode.cu.
// Takes G = 1..64, Dh in {32, 64, 128}, any S >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_decode.cuh"

// One grid launch, with flash_decode.cu's arguments and the two scale
// arrays.
extern "C" int flash_decode_quant(const void* q, int q_bf16, const void* k, const void* v,
                                  int kv_bf16, const void* k_scale, const void* v_scale,
                                  const int* pos, float* out, float* part_m, float* part_l,
                                  float* part_acc, int* count, int B, int S, int KVH, int G,
                                  int Dh, int window, int split, int nsplit, float scale,
                                  float softcap, void* stream) {
  using namespace dense_decode;
  if (const int err = check(B, S, KVH, G, split, nsplit)) return err;
  if (kv_bf16) return (int)cudaErrorInvalidValue;   // the cache is int8
  if (B == 0 || KVH == 0) return 0;
  const int ngt = (G + kMaxG - 1) / kMaxG;
  const Args a{q,     k,   v,      out,   part_m,  part_l,  part_acc, count,  G,
               ngt,   split, nsplit, scale, softcap, k_scale, v_scale};
  const dim3 grid(nsplit, KVH * ngt, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) return launch<__nv_bfloat16, int8_t>(a, Dh, grid, pos, S, KVH, window, s);
  return launch<float, int8_t>(a, Dh, grid, pos, S, KVH, window, s);
}
