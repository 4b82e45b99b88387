"""Masked inner-product top-k over the resident pool pages: the CUDA
kernel's wrapper (the unfused retrieval path's device search).

``ivf_topk`` dispatches by the tensor's device alone: a CPU tensor runs
``ivf_topk_ref``; a CUDA tensor launches ``csrc/ivf_topk.cu`` (the page
search and its merge, one grid, on the plan of ``page_topk.plan``) on the
current stream or raises.  ``ivf_topk.launches`` counts calls, one grid
launch each.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, page_topk
from repro_torch.kernels.flash_decode import _sm_count, _workspace
from repro_torch.kernels.ref import ivf_topk_ref

_SOURCE = "ivf_topk"
_fn = None


def _kernel():
    """The C entry point of the built library (built on first call)."""
    global _fn
    if _fn is None:
        fn = _build.load(_SOURCE).ivf_topk
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 9 + [I] * 10 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def _check(pages, page_ids, page_mask, queries, k) -> None:
    dev = queries.device
    for name, t in (("pages", pages), ("page_ids", page_ids),
                    ("page_mask", page_mask)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, queries on {dev}")
    B, d = queries.shape
    P, ps = page_ids.shape
    if pages.shape != (P, ps, d) or page_mask.shape not in ((P,), (B, P)):
        raise ValueError(
            f"shapes do not agree: pages {tuple(pages.shape)}, page_ids "
            f"{tuple(page_ids.shape)}, page_mask {tuple(page_mask.shape)}, "
            f"queries {tuple(queries.shape)}")
    if page_mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"page_mask must be bool or uint8, got "
                         f"{page_mask.dtype}")
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")


def ivf_topk(pages: torch.Tensor, page_ids: torch.Tensor,
             page_mask: torch.Tensor, queries: torch.Tensor, k: int,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pages [P, ps, d] bf16 / page_ids [P, ps] int32, the pool's
    ``device_view`` read in place; page_mask [P] or per-query [B, P]
    bool; queries [B, d] fp32.  Returns (scores [B, k] fp32, doc ids
    [B, k] int32): top-k of ``q_b . x`` over every vector of every page
    the query's mask admits (ids of -1 excluded), ordered by (score
    desc, flat position asc), padded with (-inf, -1)."""
    _check(pages, page_ids, page_mask, queries, k)
    if queries.device.type == "cpu":
        return ivf_topk_ref(pages, page_ids, page_mask.bool(), queries, k)
    if queries.device.type != "cuda":
        raise ValueError(f"ivf_topk runs on cpu or cuda, not {queries.device}")
    want = ((queries, torch.float32), (pages, torch.bfloat16),
            (page_ids, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise ValueError(f"kernel takes {dt} here, got {t.dtype}")
    for t in (queries, pages, page_ids, page_mask):
        if not t.is_contiguous():
            raise ValueError("ivf_topk inputs must be contiguous")
    B, d = queries.shape
    P, ps = page_ids.shape
    dev = queries.device
    rows, stages, qpass, blocks = page_topk.plan(
        B, P, ps, d, int(k), _sm_count(dev.index), pages.data_ptr() % 16 == 0)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    stride = P if page_mask.dim() == 2 else 0      # a [P] mask broadcasts
    # the current stream's handle, without building a Stream object a call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    n = blocks * B * k                              # the blocks' [B, k] lists
    count, part = _workspace(dev, stream, 1, 2 * n)
    pm = part.data_ptr()
    err = _kernel()(
        queries.data_ptr(), pages.data_ptr(), page_ids.data_ptr(),
        page_mask.data_ptr(), pm, pm + 4 * n, count.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), B, d, P, ps, int(k), stride,
        rows, stages, qpass, blocks, stream)
    if err != 0:
        raise RuntimeError(f"ivf_topk kernel launch failed: cudaError {err}")
    ivf_topk.launches += 1
    return out_s, out_i


ivf_topk.launches = 0
