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
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import _sm_count
from repro_torch.kernels.ref import centroid_probe_ref

_SOURCE = "centroid_scores"
_MAX_DIM = 12_288           # the widest d the kernel's checks cover
_ROWS = 2                   # centroid rows a warp takes (csrc kRows)
_SLICES = 8                 # vectors a lane holds of a row segment (kSlices)
_QUERY_BYTES = 48 * 1024    # shared memory for staged query segments
_fn = None


class Plan(NamedTuple):
    """How one launch covers [B, d] queries against Nc centroids."""
    vec: bool       # 16-byte loads (d % 4 == 0, both pointers aligned)
    seg: int        # floats of a row segment a warp holds in registers
    group: int      # largest query group summed at once: 8, 4, 2 or 1
    warps: int      # warps a block
    blocks: int     # block b takes rows [b * Nc // blocks, (b+1) * Nc // blocks)
    qb: int         # queries staged in shared memory at once


@functools.lru_cache(maxsize=1024)
def _plan(B: int, d: int, Nc: int, sms: int, aligned: bool) -> Plan:
    """The kernel's plan: one block per SM (a multiple of the SM count
    where a block would take more than 8 warps x _ROWS rows; never more
    blocks than rows), each a contiguous share of the rows, one warp a
    row where the share allows (at most _ROWS); a row segment of 1024
    floats (256 on the scalar path); the queries staged as many as fit
    48 KB, summed in groups of at most 8."""
    vec = aligned and d % 4 == 0
    seg = 32 * _SLICES * (4 if vec else 1)
    blocks = max(1, min(Nc, sms * -(-Nc // (sms * 8 * _ROWS))))
    warps = max(1, min(8, -(-Nc // blocks)))
    group = 1 << min(3, max(B, 1).bit_length() - 1)
    return Plan(vec, seg, group, warps, blocks,
                max(1, min(B, _QUERY_BYTES // (seg * 4))))


def _kernel():
    """The C entry point of the built library (built on first call)."""
    global _fn
    if _fn is None:
        fn = _build.load(_SOURCE).centroid_scores
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 4 + [I] * 8 + [P]
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
    dev = queries.device.index
    plan = _plan(B, d, Nc, _sm_count(dev), (queries.data_ptr() % 16 == 0
                                            and centroids.data_ptr() % 16 == 0))
    err = _kernel()(
        queries.data_ptr(), centroids.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(), B, d,
        Nc, int(plan.vec), plan.group, plan.warps, plan.blocks, plan.qb,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"centroid_scores kernel launch failed: "
                           f"cudaError {err}")
    centroid_scores.launches += 1
    return out


centroid_scores.launches = 0
