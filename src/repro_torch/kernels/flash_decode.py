"""Paged single-token decode attention: the CUDA kernel's wrapper and its
plain version.

``flash_decode_paged`` dispatches by the tensor's device alone: a CPU
tensor runs ``flash_decode_paged_ref``; a CUDA tensor launches
``csrc/flash_decode_paged.cu`` on the current stream (built on first
use) or raises.  ``flash_decode_paged.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_paged_ref

_SOURCE = "flash_decode_paged"
_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
           (torch.float32, torch.float32))      # (q, k/v) pairs the kernel takes
_fn = None


def _kernel():
    """The C entry point of the built library (built on first call)."""
    global _fn
    if _fn is None:
        fn = _build.load(_SOURCE).flash_decode_paged
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, I, P, P, P, I, I, I, I, I, I, I,
                       ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def _check(q, k_pages, v_pages, block_table, lengths) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"want q [B,KVH,G,Dh] and k/v [NP,ps,KVH,Dh], got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, KVH, G, Dh = q.shape
    if k_pages.shape[2:] != (KVH, Dh):
        raise ValueError(f"k/v pages {tuple(k_pages.shape)} do not match q "
                         f"heads ({KVH}, {Dh})")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Block-table decode attention over paged KV, read in place.

    q [B, KVH, G, Dh]; k_pages, v_pages [NP, ps, KVH, Dh]; block_table
    [B, MB] int32 (-1 = unused tail); lengths [B] int32 valid tokens
    (>= 1).  Returns [B, KVH, G, Dh] fp32, equal to
    ``flash_decode_paged_ref`` within fp32 summation-order error.
    """
    _check(q, k_pages, v_pages, block_table, lengths)
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, k_pages, v_pages, block_table,
                                      lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged runs on cpu or cuda, not {q.device}")
    B, KVH, G, Dh = q.shape
    NP, ps, _, _ = k_pages.shape
    MB = block_table.shape[1]
    if not 1 <= G <= 8 or Dh not in (32, 64, 128):
        raise ValueError(f"kernel takes G in 1..8 and Dh in (32, 64, 128); "
                         f"got G={G}, Dh={Dh}")
    if (q.dtype, k_pages.dtype) not in _DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"q {q.dtype}, k/v {k_pages.dtype}/{v_pages.dtype}: "
                         "kernel takes q/kv bf16/bf16, fp32/bf16 or fp32/fp32")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((B, KVH, G, Dh), dtype=torch.float32, device=q.device)
    err = _kernel()(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), int(k_pages.dtype == torch.bfloat16),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, KVH, G, Dh, ps, MB, int(window), 1.0 / math.sqrt(Dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_paged kernel launch failed: "
                           f"cudaError {err}")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
