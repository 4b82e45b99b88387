// Masked inner-product top-k over the resident pool pages, with the page
// mask given by the caller (the unfused retrieval path: hybrid search
// builds a per-query [B, P] mask on the host from the resident probed
// clusters).
//
// Replaces: src/repro/kernels/ivf_topk.py, ivf_topk_flat (Pallas body
//           _kernel, helper _tile_topk).
//
// Bound on an H100: bytes.  The work is one pass over the pool pages that
// some query admits (ps * d bf16 values per page, 2 * B flops per value),
// far below the ~20 flop/byte at which even the fp32 CUDA cores would
// limit, so the design streams the admitted pages once at the memory's
// rate.  The TPU kernel streams a flattened, padded slab through one
// sequential grid and carries a running top-k in scratch across tiles;
// here a persistent grid splits the admitted pages' row chunks evenly
// over the SMs, stages them with TMA bulk copies, keeps a running top-k
// per block and merges the blocks' lists in the same launch
// (page_topk.cuh, which describes it).  The pool's pages are read in
// place: the flatten-and-pad the TPU tiling needed is gone.
//
// Layouts: q [B, d] fp32; pages [P, ps, d] bf16; page_ids [P, ps] int32
// (-1 = padding); mask [B, P] (mask_stride P) or [P] shared by every
// query (mask_stride 0), one byte each; cand_s / cand_o [blocks, B, k]
// scratch; count: one int, 0 between launches; outputs scores [B, k]
// fp32 and ids [B, k] int32, (-inf, -1) where fewer than k vectors
// qualify.

#include <cuda_runtime.h>
#include <stdint.h>

#include "page_topk.cuh"

// One grid on `stream`.
extern "C" int ivf_topk(const float* q, const void* pages, const int* page_ids,
                        const uint8_t* mask, float* cand_s, int* cand_o, int* count,
                        float* out_s, int* out_i, int B, int d, int P, int ps, int k,
                        int mask_stride, int rows, int stages, int pass, int blocks,
                        void* stream) {
  if (d < 1 || ps < 1 || k < 1 || mask_stride < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return page_topk::search(q, pages, page_ids, page_topk::PageMaskAdmit{mask, mask_stride},
                           cand_s, cand_o, count, out_s, out_i, B, P, ps, d, k,
                           page_topk::Plan{rows, stages, pass}, blocks,
                           static_cast<cudaStream_t>(stream));
}
