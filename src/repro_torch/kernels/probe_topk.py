"""Fused IVF retrieval over resident pool pages: the CUDA kernel's wrapper
and its plain version.

``probe_topk_fused`` dispatches by the tensor's device alone: a CPU
tensor runs ``probe_and_topk_ref``; a CUDA tensor launches
``csrc/probe_topk.cu`` (three kernels: probe + threshold, page search,
merge) on the current stream or raises.  ``probe_topk_fused.launches``
counts wrapper launches (one per call, whatever the kernel count).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import probe_and_topk_ref

_SOURCE = "probe_topk"
_fn = None


def _kernel():
    """The C entry point of the built library (built on first call)."""
    global _fn
    if _fn is None:
        fn = _build.load(_SOURCE).probe_topk_fused
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 11 + [I] * 8 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def _check(queries, centroids, valid, pages, page_ids, page_cluster) -> None:
    dev = queries.device
    for name, t in (("centroids", centroids), ("valid", valid),
                    ("pages", pages), ("page_ids", page_ids),
                    ("page_cluster", page_cluster)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, queries on {dev}")
    B, d = queries.shape
    Nc = centroids.shape[0]
    P, ps = page_ids.shape
    if centroids.shape != (Nc, d) or valid.shape != (Nc,) \
            or pages.shape != (P, ps, d) or page_cluster.shape != (P,):
        raise ValueError(
            f"shapes do not agree: queries {tuple(queries.shape)}, centroids "
            f"{tuple(centroids.shape)}, valid {tuple(valid.shape)}, pages "
            f"{tuple(pages.shape)}, page_ids {tuple(page_ids.shape)}, "
            f"page_cluster {tuple(page_cluster.shape)}")


def probe_topk_fused(queries: torch.Tensor, centroids: torch.Tensor,
                     valid: torch.Tensor, pages: torch.Tensor,
                     page_ids: torch.Tensor, page_cluster: torch.Tensor, *,
                     nprobe: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [B, d] fp32; centroids [Nc, d] fp32; valid [Nc] bool;
    pages [P, ps, d] bf16 / page_ids [P, ps] int32 / page_cluster [P]
    int32, the pool's ``device_view`` read in place.  Returns (scores
    [B, k] fp32, doc ids [B, k] int32): top-k over every page whose
    cluster is among the query's top-``nprobe`` valid centroids (the
    kernel admits every cluster tied at the nprobe-th score)."""
    _check(queries, centroids, valid, pages, page_ids, page_cluster)
    if queries.device.type == "cpu":
        return probe_and_topk_ref(queries, centroids, valid, pages, page_ids,
                                  page_cluster, nprobe, k)
    if queries.device.type != "cuda":
        raise ValueError(f"probe_topk_fused runs on cpu or cuda, not "
                         f"{queries.device}")
    want = ((queries, torch.float32), (centroids, torch.float32),
            (valid, torch.bool), (pages, torch.bfloat16),
            (page_ids, torch.int32), (page_cluster, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise ValueError(f"kernel takes {dt} here, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("probe_topk_fused inputs must be contiguous")
    B, d = queries.shape
    Nc = centroids.shape[0]
    P, ps = page_ids.shape
    if not 1 <= nprobe <= Nc or k < 1:
        raise ValueError(f"need 1 <= nprobe <= Nc ({Nc}) and k >= 1; got "
                         f"nprobe={nprobe}, k={k}")
    dev = queries.device
    admit = torch.empty((B, Nc), dtype=torch.uint8, device=dev)
    cand_s = torch.empty((P, B, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((P, B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    vec = int(d % 8 == 0 and pages.data_ptr() % 16 == 0)
    err = _kernel()(
        queries.data_ptr(), centroids.data_ptr(), valid.data_ptr(),
        pages.data_ptr(), page_ids.data_ptr(), page_cluster.data_ptr(),
        admit.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), B, d, Nc, P, ps, int(nprobe),
        int(k), vec, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_topk_fused kernel launch failed: "
                           f"cudaError {err}")
    probe_topk_fused.launches += 1
    return out_s, out_i


probe_topk_fused.launches = 0
