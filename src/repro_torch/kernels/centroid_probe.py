"""Masked centroid scores (the IVF coarse probe): the CUDA kernel's
wrapper.

``centroid_scores`` dispatches by the tensor's device alone: a CPU tensor
runs ``centroid_probe_ref``; a CUDA tensor launches
``csrc/centroid_scores.cu`` on the current stream (built on first use)
or raises.  ``centroid_scores.launches`` counts kernel launches: one
per call with at least one query and one centroid.  The top-nprobe
selection runs outside the kernel (``ops.centroid_probe``), as the
reference runs ``lax.top_k`` outside its kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import centroid_probe_ref

_SOURCE = "centroid_scores"
_MAX_DIM = 12_288           # one query row must fit the kernel's 48 KB stage
_fn = None


def _kernel():
    """The C entry point of the built library (built on first call)."""
    global _fn
    if _fn is None:
        fn = _build.load(_SOURCE).centroid_scores
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 4 + [I] * 3 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def _check(queries, centroids, valid) -> None:
    dev = queries.device
    if centroids.device != dev or (valid is not None and valid.device != dev):
        raise ValueError(f"centroids/valid on another device than queries "
                         f"({dev})")
    if queries.dim() != 2 or centroids.dim() != 2 \
            or centroids.shape[1] != queries.shape[1]:
        raise ValueError(f"want queries [B,d] and centroids [Nc,d], got "
                         f"{tuple(queries.shape)}, {tuple(centroids.shape)}")
    if valid is not None and (valid.shape != (centroids.shape[0],)
                              or valid.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"valid must be bool or uint8 [Nc], got "
                         f"{valid.dtype} {tuple(valid.shape)}")


def centroid_scores(queries: torch.Tensor, centroids: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """queries [B, d] fp32; centroids [Nc, d] fp32; valid [Nc] bool
    (None = all valid).  Returns ``queries @ centroids.T`` [B, Nc] fp32
    with -inf where a centroid is invalid, in full fp32 (no TF32)."""
    _check(queries, centroids, valid)
    if queries.device.type == "cpu":
        return centroid_probe_ref(centroids, queries,
                                  None if valid is None else valid.bool())
    if queries.device.type != "cuda":
        raise ValueError(f"centroid_scores runs on cpu or cuda, not "
                         f"{queries.device}")
    for name, t in (("queries", queries), ("centroids", centroids)):
        if t.dtype != torch.float32:
            raise ValueError(f"kernel takes fp32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if valid is not None and not valid.is_contiguous():
        raise ValueError("valid must be contiguous")
    B, d = queries.shape
    Nc = centroids.shape[0]
    if d > _MAX_DIM:
        raise ValueError(f"kernel takes d <= {_MAX_DIM}, got {d}")
    out = torch.empty((B, Nc), dtype=torch.float32, device=queries.device)
    if B == 0 or Nc == 0:
        return out                                # nothing to launch
    err = _kernel()(
        queries.data_ptr(), centroids.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(), B, d,
        Nc, torch.cuda.current_stream(queries.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"centroid_scores kernel launch failed: "
                           f"cudaError {err}")
    centroid_scores.launches += 1
    return out


centroid_scores.launches = 0
