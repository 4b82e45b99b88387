"""Absorbed multi-head latent attention for one decode token (MLA,
minicpm3): the CUDA kernel's wrapper and its plain version.

``mla_decode`` dispatches by the tensor's device alone: a CPU tensor runs
``mla_decode_ref``; a CUDA tensor launches ``csrc/mla_decode.cu`` on the
current stream (built on first use) or raises.  The reference has no
Pallas kernel here (its ``models/mla.py`` attends in jnp).  Over a bf16
cache the kernel runs both products on the tensor cores as three bf16
products of exact pieces of the fp32 queries and probabilities, a block
a (split, 16-head tile, row); over an fp32 cache it keeps fp32 products
on the CUDA cores, a block a (split, row).  Either way it combines its
splits over positions inside the one launch, as the decode kernels do,
so ``mla_decode.launches`` counts one grid launch a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import _sm_count, _workspace
from repro_torch.kernels.ref import mla_decode_ref

_CHUNK = {True: 64, False: 32}    # positions a step, bf16 / fp32 cache (csrc kChunk)
_TILE = 16                        # heads a block over a bf16 cache (csrc tc::kTile)
_MAX_H = 64                       # heads a call may have (csrc kMaxH)
_MAX_SPLITS = 128                 # bf16 splits a row: their combine's (m, l, weight) fit a block
_SHAPES = ((256, 32), (32, 16))   # (R, Dr) the kernel is compiled for
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] + [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P]
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.load("mla_decode").mla_decode
        _fn.argtypes = _ARGTYPES
        _fn.restype = _I
    return _fn


@functools.lru_cache(maxsize=256)
def _plan(B: int, S: int, H: int, sms: int, bf16: bool) -> Tuple[int, int, int]:
    """(positions per split, splits a row, head tiles a row): about two
    blocks an SM (two fit) over the B rows times the head tiles (16 heads
    each over a bf16 cache; one tile of all H over fp32), each split a
    whole number of chunks (64 positions over bf16, 32 over fp32); at
    most _MAX_SPLITS splits over bf16."""
    chunk = _CHUNK[bf16]
    tiles = -(-H // _TILE) if bf16 else 1
    n = max(1, min(-(-2 * sms // max(B * tiles, 1)), -(-S // chunk)))
    if bf16:
        n = min(n, _MAX_SPLITS)
    per = -(-S // n)
    split = -(-per // chunk) * chunk
    return split, -(-S // split), tiles


def _check(q_abs, q_pe, ckv, kpe, pos) -> None:
    dev = q_abs.device
    for name, t in (("q_pe", q_pe), ("ckv", ckv), ("kpe", kpe), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q_abs on {dev}")
    if q_abs.dim() != 3 or q_pe.dim() != 3 or ckv.dim() != 3 or kpe.dim() != 3:
        raise ValueError("want q_abs [B,H,R], q_pe [B,H,Dr], ckv [B,S,R] and "
                         "kpe [B,S,Dr]")
    B, H, R = q_abs.shape
    S, Dr = ckv.shape[1], kpe.shape[2]
    if (q_pe.shape != (B, H, Dr) or ckv.shape != (B, S, R)
            or kpe.shape != (B, S, Dr) or pos.shape != (B,) or S < 1):
        raise ValueError(f"shapes do not match: q_abs {tuple(q_abs.shape)}, "
                         f"q_pe {tuple(q_pe.shape)}, ckv {tuple(ckv.shape)}, "
                         f"kpe {tuple(kpe.shape)}, pos {tuple(pos.shape)}")


def mla_decode(q_abs: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
               kpe: torch.Tensor, pos: torch.Tensor, scale: float,
               ) -> torch.Tensor:
    """The attention-weighted latent of one decode token per row.

    q_abs [B, H, R] and q_pe [B, H, Dr] fp32 (the absorbed no-rope query
    and the rotary one); ckv [B, S, R] and kpe [B, S, Dr], the latent
    cache, bf16 or fp32; pos [B] int32, the new token's position
    (positions > pos are masked).  Scores ``(q_abs . ckv_t + q_pe .
    kpe_t) * scale``, softmax over t, then the probabilities times ckv,
    all fp32.  Returns [B, H, R] fp32, equal to ``mla_decode_ref`` within
    fp32 summation-order error.  On the card: H up to 64, (R, Dr) of
    minicpm3 (256, 32) or its reduced config (32, 16)."""
    _check(q_abs, q_pe, ckv, kpe, pos)
    if q_abs.device.type == "cpu":
        return mla_decode_ref(q_abs, q_pe, ckv, kpe, pos, scale)
    if q_abs.device.type != "cuda":
        raise ValueError(f"mla_decode runs on cpu or cuda, not {q_abs.device}")
    B, H, R = q_abs.shape
    S, Dr = ckv.shape[1], kpe.shape[2]
    if not 1 <= H <= _MAX_H or (R, Dr) not in _SHAPES:
        raise ValueError(f"kernel takes H in 1..{_MAX_H} and (R, Dr) in "
                         f"{_SHAPES}; got H={H}, R={R}, Dr={Dr}")
    if q_abs.dtype != torch.float32 or q_pe.dtype != torch.float32:
        raise ValueError("q_abs and q_pe must be fp32")
    if ckv.dtype not in (torch.bfloat16, torch.float32) or kpe.dtype != ckv.dtype:
        raise ValueError(f"ckv/kpe {ckv.dtype}/{kpe.dtype}: kernel takes "
                         "bf16 or fp32, both alike")
    if pos.dtype != torch.int32:
        raise ValueError("pos must be int32")
    for name, t in (("q_abs", q_abs), ("q_pe", q_pe), ("ckv", ckv),
                    ("kpe", kpe), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "pos" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    dev = q_abs.device
    bf16 = ckv.dtype == torch.bfloat16
    split, nsplit, tiles = _plan(B, S, H, _sm_count(dev.index), bf16)
    out = torch.empty((B, H, R), dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    n = B * nsplit * H if nsplit > 1 else 0
    n4 = -(-n // 4) * 4                 # the partial acc 16-byte aligned
    count, part = _workspace(dev, stream, B * tiles, 2 * n4 + n * R)
    pm = part.data_ptr()
    err = _kernel()(
        q_abs.data_ptr(), q_pe.data_ptr(), ckv.data_ptr(), kpe.data_ptr(),
        int(bf16), pos.data_ptr(), out.data_ptr(), pm,
        pm + 4 * n4, pm + 8 * n4, count.data_ptr(), B, S, H, R, Dr, split,
        nsplit, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"mla_decode kernel launch failed: cudaError {err}")
    mla_decode.launches += 1
    return out


mla_decode.launches = 0
