"""Single-token decode attention, dense, paged and spliced: the CUDA
kernels' wrappers and their plain versions.

``flash_decode`` (dense [B, S, KVH, Dh] cache, per-row ``pos``, an
optional sliding window and score softcap), ``flash_decode_quant`` (the
same over an int8 cache with per-(position, kv-head) bf16 scales),
``flash_decode_paged`` (block-table KV) and ``flash_decode_spliced
(block-table KV with spliced chunk-KV pages: a RoPE offset and a
live-token count per page) dispatch by the tensor's device alone: a CPU
tensor runs ``flash_decode_ref`` / ``flash_decode_quant_ref`` /
``flash_decode_paged_ref`` / ``flash_decode_spliced_ref``; a CUDA tensor
launches ``csrc/flash_decode.cu`` / ``csrc/flash_decode_quant.cu`` /
``csrc/flash_decode_paged.cu`` / ``csrc/flash_decode_spliced.cu`` on the
current stream (built on first use) or raises.  All four kernels split every sequence over positions
(``_splits``: whole 64-position chunks, enough blocks for several per SM)
and combine the splits inside the same launch, so each wrapper's
``launches`` counts one grid launch a call.  Each takes Dh 32, 64 and
128; ``flash_decode`` also 80 (zamba2's shared attention), and on a CUDA
tensor every wrapper refuses any other Dh rather than run the plain
version.  A kv-head's G query rows
share a block up to ``_MAX_G``; past it (to ``_MAX_ROWS``: granite-20b's
MQA has G = 48) they go in tiles of ``_MAX_G`` rows, a block each, on
the grid's kv-head dimension (``_tiles``), in the same single launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_decode_paged_ref,
                                     flash_decode_quant_ref, flash_decode_ref,
                                     flash_decode_spliced_ref)
from repro_torch.models.layers import rope_frequencies

_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
           (torch.float32, torch.float32))      # (q, k/v) pairs the kernels take
_QUANT_DTYPES = ((torch.bfloat16, torch.int8), (torch.float32, torch.int8))
_DHS = (32, 64, 128)    # head dims the kernels are built for
_DENSE_DHS = (32, 64, 80, 128)   # and the dense bf16/fp32 kernel (zamba2's 80)
_CHUNK = 64             # positions per softmax step (csrc/decode_attn.cuh)
_MAX_G = 8              # query rows a block holds (kMaxG)
_MAX_ROWS = 64          # query rows a kv-head may have (kMaxRows)
_TAB = 256              # cos/sin pairs of a chunk's angle table (spliced kTab)
FRESH, MASKED, ROTATED = 0, 1, 2   # the spliced kernel's chunk modes
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "flash_decode_paged": [_P, _I, _P, _P, _I, _P, _P] + [_P] * 5 + [_I] * 9
                          + [ctypes.c_float, _P],
    "flash_decode": [_P, _I, _P, _P, _I] + [_P] * 6 + [_I] * 8
                    + [ctypes.c_float] * 2 + [_P],
    "flash_decode_quant": [_P, _I, _P, _P, _I] + [_P] * 8 + [_I] * 8
                          + [ctypes.c_float] * 2 + [_P],
    "flash_decode_spliced": [_P, _I, _P, _P, _I] + [_P] * 10 + [_I] * 12
                            + [ctypes.c_float, _P],
}
_fns = {}
_sms: Dict[int, int] = {}                          # device index -> SM count
# (device index, stream) -> (split counters [rows] int32, zero between
# launches; fp32 scratch for the splits' partial (m, l, acc))
_work: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
# (device index, Dh, rope fraction, theta) -> the fp32 RoPE frequencies
# [max(rot/2, 1)] the spliced kernel reads, from the port's own
# rope_frequencies on that device (the plain version's table)
_freqs: Dict[Tuple[int, int, float, float], torch.Tensor] = {}


def _kernel(name: str):
    """The C entry point ``name`` of ``csrc/<name>.cu`` (built on first
    call)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(name), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _fns[name] = fn
    return fn


def _check_launch(q: torch.Tensor, kv: torch.Tensor, v: torch.Tensor,
                  pairs=_DTYPES, dhs=_DHS, **ints: torch.Tensor) -> None:
    """What the CUDA kernels take: G in 1..64, Dh in ``dhs`` (32, 64 and
    128; the dense kernel 80 too), q/kv dtypes among ``pairs``
    (bf16/bf16, fp32/bf16 or fp32/fp32; the int8 kernel bf16/int8 or
    fp32/int8), int32 index tensors, and every tensor contiguous."""
    G, Dh = q.shape[2], q.shape[3]
    if not 1 <= G <= _MAX_ROWS or Dh not in dhs:
        raise ValueError(f"kernel takes G in 1..{_MAX_ROWS} and Dh in "
                         f"{dhs}; got G={G}, Dh={Dh}")
    if (q.dtype, kv.dtype) not in pairs or v.dtype != kv.dtype:
        raise ValueError(f"q {q.dtype}, k/v {kv.dtype}/{v.dtype}: kernel "
                         "takes q/kv " + ", ".join(
                             f"{a}/{b}" for a, b in pairs))
    if any(t.dtype != torch.int32 for t in ints.values()):
        raise ValueError(f"{' and '.join(ints)} must be int32")
    for name, t in (("q", q), ("k", kv), ("v", v), *ints.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kv.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary")


@functools.lru_cache(maxsize=1024)
def _splits(rows: int, S: int, sms: int) -> Tuple[int, int]:
    """The split plan of both kernels: (positions per split, splits per
    (b, kv-head)) over S positions (the dense cache's S, or the block
    table's MB * ps): enough blocks for about four per SM, each a whole
    number of softmax chunks, together covering the S positions."""
    n = max(1, min(-(-4 * sms // max(rows, 1)), -(-S // _CHUNK)))
    per = -(-S // n)
    split = -(-per // _CHUNK) * _CHUNK            # whole chunks
    return split, -(-S // split)


def _tiles(G: int) -> int:
    """Blocks a (b, kv-head) takes for its G query rows: ceil(G / _MAX_G)
    tiles (csrc/decode_attn.cuh's ngt)."""
    return -(-G // _MAX_G)


def _sm_count(index: int) -> int:
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def _workspace(device: torch.device, stream: int, rows: int, floats: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counters, scratch) for one launch on ``stream``: at least ``rows``
    int32 split counters, zeroed when made and left zero by every launch,
    and ``floats`` fp32 of scratch.  Kept per (device, stream), so
    launches that share them run in stream order; grown as needed."""
    key = (device.index, stream)
    count, part = _work.get(key, (None, None))
    if count is None or count.numel() < rows:
        count = torch.zeros((max(rows, 256),), dtype=torch.int32, device=device)
    if part is None or part.numel() < floats:
        part = torch.empty((max(floats, 1 << 16),), dtype=torch.float32,
                           device=device)
    _work[key] = (count, part)
    return count, part


def _launch(name: str, q: torch.Tensor, kv: torch.Tensor, v: torch.Tensor,
            S: int, head: tuple, tail: tuple, floats: tuple = ()) -> torch.Tensor:
    """One grid launch of kernel ``name`` over S positions a row; ``head``
    are the arguments between k/v and the output, ``tail`` those between
    the counters and (split, nsplit), ``floats`` those after the scale."""
    B, KVH, G, Dh = q.shape
    rows = B * KVH
    blocks = rows * _tiles(G)           # (b, kv-head, G tile) blocks a split
    dev = q.device
    split, nsplit = _splits(blocks, S, _sm_count(dev.index))
    out = torch.empty((B, KVH, G, Dh), dtype=torch.float32, device=dev)
    # the current stream's handle, as torch.cuda.current_stream(dev)
    # .cuda_stream gives it, without building a Stream object a call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    n = rows * nsplit * G if nsplit > 1 else 0
    count, part = _workspace(dev, stream, blocks, n * (Dh + 2))
    pm = part.data_ptr()
    err = _kernel(name)(
        q.data_ptr(), int(q.dtype == torch.bfloat16), kv.data_ptr(),
        v.data_ptr(), int(kv.dtype == torch.bfloat16), *head, out.data_ptr(),
        pm, pm + 4 * n, pm + 8 * n, count.data_ptr(), *tail,
        split, nsplit, 1.0 / math.sqrt(Dh), *floats, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def _check_dense(q, k, v, pos) -> None:
    dev = q.device
    for name, t in (("k", k), ("v", v), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,KVH,G,Dh] and k/v [B,S,KVH,Dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, KVH, G, Dh = q.shape
    if k.shape[0] != B or k.shape[2:] != (KVH, Dh) or k.shape[1] < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if pos.shape != (B,):
        raise ValueError(f"pos {tuple(pos.shape)} does not match batch {B}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over a dense cache.

    q [B, KVH, G, Dh]; k, v [B, S, KVH, Dh]; pos [B] int32, the new
    token's position (positions > pos are masked; ``window`` > 0 keeps
    only the last ``window``; ``softcap`` > 0 caps each scaled score at
    ``softcap * tanh(s / softcap)``).  Returns [B, KVH, G, Dh] fp32,
    equal to ``flash_decode_ref`` within fp32 summation-order error.  On
    the card it runs one grid launch, splits and their combine together;
    ``flash_decode.launches`` counts it.
    """
    _check_dense(q, k, v, pos)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, not {q.device}")
    _check_launch(q, k, v, dhs=_DENSE_DHS, pos=pos)
    B, KVH, G, Dh = q.shape
    S = k.shape[1]
    out = _launch("flash_decode", q, k, v, S, (pos.data_ptr(),),
                  (B, S, KVH, G, Dh, int(window)), (float(softcap),))
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       pos: torch.Tensor, *, window: int = 0,
                       softcap: float = 0.0) -> torch.Tensor:
    """``flash_decode`` over an int8 cache: k, v int8 [B, S, KVH, Dh] with
    bf16 scales k_scale, v_scale [B, S, KVH], each row dequantized as the
    reference's ``dequantize_heads`` does (fp32 product, rounded to
    bf16).  The card reads the cache once at one byte an element and
    dequantizes each row in the kernel.  Returns [B, KVH, G, Dh] fp32,
    equal to ``flash_decode_quant_ref`` within fp32 summation-order
    error; ``flash_decode_quant.launches`` counts its grid launches, one
    a call."""
    _check_dense(q, k, v, pos)
    B, S, KVH, _ = k.shape
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device or t.shape != (B, S, KVH):
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}: want "
                             f"{(B, S, KVH)} on {q.device}")
    if q.device.type == "cpu":
        return flash_decode_quant_ref(q, k, v, k_scale, v_scale, pos,
                                      window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_quant runs on cpu or cuda, not "
                         f"{q.device}")
    _check_launch(q, k, v, _QUANT_DTYPES, pos=pos)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bf16, got {t.dtype}")
    G, Dh = q.shape[2:]
    out = _launch("flash_decode_quant", q, k, v, S,
                  (k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr()),
                  (B, S, KVH, G, Dh, int(window)), (float(softcap),))
    flash_decode_quant.launches += 1
    return out


flash_decode_quant.launches = 0


def _check_paged(q, k_pages, v_pages, block_table, lengths, **tables) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths),
                    *tables.items()):
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
    for name, t in tables.items():
        if t.shape != block_table.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"block_table {tuple(block_table.shape)}")


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Block-table decode attention over paged KV, read in place.

    q [B, KVH, G, Dh]; k_pages, v_pages [NP, ps, KVH, Dh]; block_table
    [B, MB] int32 (-1 = unused tail); lengths [B] int32 valid tokens
    (>= 1).  Returns [B, KVH, G, Dh] fp32, equal to
    ``flash_decode_paged_ref`` within fp32 summation-order error.  On the
    card it runs one grid launch, split over the MB * ps table positions
    as ``flash_decode`` splits S; ``flash_decode_paged.launches`` counts it.
    """
    _check_paged(q, k_pages, v_pages, block_table, lengths)
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, k_pages, v_pages, block_table,
                                      lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged runs on cpu or cuda, not {q.device}")
    _check_launch(q, k_pages, v_pages, block_table=block_table,
                  lengths=lengths)
    B, KVH, G, Dh = q.shape
    ps = k_pages.shape[1]
    MB = block_table.shape[1]
    out = _launch("flash_decode_paged", q, k_pages, v_pages, MB * ps,
                  (block_table.data_ptr(), lengths.data_ptr()),
                  (B, KVH, G, Dh, ps, MB, int(window)))
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def _rope_table(dev: torch.device, Dh: int, fraction: float,
                theta: float) -> torch.Tensor:
    key = (dev.index, Dh, float(fraction), float(theta))
    t = _freqs.get(key)
    if t is None:
        f = rope_frequencies(Dh, fraction, theta, device=dev)
        t = _freqs[key] = f if f.numel() else torch.zeros(1, device=dev)
    return t


@functools.lru_cache(maxsize=256)
def _splice_plan(Dh: int, kv_bf16: bool, rot: int) -> Tuple[int, int, int]:
    """The spliced kernel's plan for Dh, the page dtype and ``rot``
    rotated dims: (partner lane distance, angle-table runs a chunk, fresh
    path).  A lane holds V = 8 (bf16) or 4 (fp32) dims of a row, Dh / V
    lanes a row; the rotate-half partner of dim i (i +- rot/2) is in lane
    ``lane ^ dist`` when rot/2 is a multiple of V and dist = rot/2 / V is
    a power of two below the row's lanes, else 0 (partners read from
    shared memory).  The table holds _TAB cos/sin pairs, rot/2 a run; 1:
    a chunk whose every position is fresh skips the splice code."""
    V = 8 if kv_bf16 else 4
    half = rot // 2
    dist = half // V if half and half % V == 0 else 0
    if dist & (dist - 1) or dist >= Dh // V:
        dist = 0
    return dist, min(_TAB // half, _CHUNK) if half else 0, 1


def spliced_chunks(block_table: torch.Tensor, lengths: torch.Tensor,
                   page_delta: torch.Tensor, page_valid: torch.Tensor,
                   ps: int, rot: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """How the spliced kernel takes each 64-position chunk of each row
    (chunks start at multiples of 64 whatever the split, every split
    being whole chunks): (mode [B, C], runs [B, C]) over C = ceil(MB * ps
    / 64) chunks.  Mode ``FRESH``: every position below the row's length
    is live with delta 0, so the chunk runs the unspliced code;
    ``MASKED``: some position is dead (past its page's valid count), none
    rotated; ``ROTATED``: some live position has a nonzero delta (and
    rot > 0); -1: the chunk starts at or past the row's length.  Runs:
    the rotated chunk's runs of one nonzero delta over consecutive rotated
    positions, the angle-table entries it needs.  Computed on the host
    from the tables, as the kernel's warp 0 computes it."""
    bt = block_table.cpu()
    B, MB = bt.shape
    C = -(-MB * ps // _CHUNK)
    pos = torch.arange(C * _CHUNK)
    pg = (pos // ps).clamp(max=MB - 1)
    inlen = pos[None, :] < lengths.cpu().long().clamp(0, MB * ps)[:, None]
    live = inlen & ((pos % ps)[None, :] < page_valid.cpu().long()[:, pg])
    dl = torch.where(live, page_delta.cpu().long()[:, pg], 0)
    rt = live & (dl != 0) & (rot > 0)
    first = (pos % _CHUNK == 0)[None, :]
    prev_rt = torch.nn.functional.pad(rt, (1, 0))[:, :-1]
    prev_dl = torch.nn.functional.pad(dl, (1, 0))[:, :-1]
    start = rt & (first | ~prev_rt | (prev_dl != dl))
    view = lambda t: t.reshape(B, C, _CHUNK)
    mode = torch.where(view(rt).any(-1), ROTATED,
                       torch.where((view(live) == view(inlen)).all(-1), FRESH,
                                   MASKED))
    mode = torch.where(view(inlen)[..., 0], mode, -1)
    return mode, view(start).sum(-1)


def flash_decode_spliced(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, page_delta: torch.Tensor,
                         page_valid: torch.Tensor, *,
                         rope_fraction: float = 1.0,
                         rope_theta: float = 10_000.0) -> torch.Tensor:
    """Block-table decode attention over paged KV that holds spliced
    chunk-KV pages, read in place.

    q [B, KVH, G, Dh]; k_pages, v_pages [NP, ps, KVH, Dh]; block_table,
    page_delta, page_valid [B, MB] int32 (-1 columns carry valid 0);
    lengths [B] int32 layout positions (>= 1; the new token at
    ``lengths - 1``).  Each page's K is rotated by its ``page_delta``
    (rotate-half RoPE over ``rope_fraction`` of Dh, base ``rope_theta``)
    and rounded back to the page dtype before the fp32 product; slots at
    or past a page's ``page_valid`` are masked and never read.  Returns
    [B, KVH, G, Dh] fp32, equal to ``flash_decode_spliced_ref`` within
    fp32 summation-order error.  On the card one grid launch, split as
    ``flash_decode_paged`` splits; ``flash_decode_spliced.launches``
    counts it.
    """
    _check_paged(q, k_pages, v_pages, block_table, lengths,
                 page_delta=page_delta, page_valid=page_valid)
    if q.device.type == "cpu":
        return flash_decode_spliced_ref(
            q, k_pages, v_pages, block_table, lengths, page_delta,
            page_valid, rope_fraction=rope_fraction, rope_theta=rope_theta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_spliced runs on cpu or cuda, not "
                         f"{q.device}")
    _check_launch(q, k_pages, v_pages, block_table=block_table,
                  lengths=lengths, page_delta=page_delta,
                  page_valid=page_valid)
    B, KVH, G, Dh = q.shape
    ps = k_pages.shape[1]
    MB = block_table.shape[1]
    rot = int(Dh * rope_fraction) // 2 * 2
    freq = _rope_table(q.device, Dh, rope_fraction, rope_theta)
    out = _launch("flash_decode_spliced", q, k_pages, v_pages, MB * ps,
                  (block_table.data_ptr(), lengths.data_ptr(),
                   page_delta.data_ptr(), page_valid.data_ptr(),
                   freq.data_ptr()),
                  (B, KVH, G, Dh, ps, MB, rot,
                   *_splice_plan(Dh, k_pages.dtype == torch.bfloat16, rot)))
    flash_decode_spliced.launches += 1
    return out


flash_decode_spliced.launches = 0
