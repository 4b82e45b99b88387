"""Microbenchmark of the ways to dequantize an int8 K/V value on the card
(``dequant_bench.cu`` beside this file, not a kernel of the port), for
the choice in ``csrc/decode_attn.cuh``.

    PYTHONPATH=src python -m repro_torch.kernels.dequant_bench

Each candidate is run on every int8 value in [-127, 127] times every
bf16 scale in [1e-8, 1e4] and must equal ``ref.dequantize_ref`` bit for
bit; then each is timed (CUDA events, the median of 7 launches) in a loop
shaped like the decode kernel's score loop at G = 2.  Prints one line a
candidate and, last, a JSON object of the results.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize_ref

NAMES = ("parent: I2F, FMUL, F2F, widen",
         "magic byte + FFMA, integer round",
         "magic byte + FFMA, cvt.rn.bf16x2.f32 pair, widen",
         "exact x, bf16 pair, fma.rn.bf16x2, widen",
         "magic byte + FFMA, Veltkamp split")
BLOCKS = 132 * 16          # 16 blocks of 128 threads an SM's worth
ITERS = 4096               # rows a thread


def scales() -> torch.Tensor:
    """Every positive bf16 value in [1e-8, 1e4], as fp32."""
    bits = torch.arange(0, 0x7F80, dtype=torch.int32).to(torch.int16)
    s = bits.view(torch.bfloat16).float()
    return s[(s >= 1e-8) & (s <= 1e4)]


def load():
    """``dequant_bench.cu`` built by nvcc into the kernels' build
    directory and loaded."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "libdequant_bench.so"
    src = Path(__file__).resolve().with_suffix(".cu")
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                    "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib)).dequant_bench


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("dequant_bench needs a CUDA card")
    fn = load()
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    x = torch.cat([torch.arange(-127, 128), torch.zeros(1)]).to(torch.int8)
    s = scales()
    want = dequantize_ref(x[None, :].expand(len(s), -1),
                          s.to(torch.bfloat16)).float()
    xs, ss = x.cuda(), s.cuda()
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(-127, 128, 64 * 128, dtype=np.int8)).cuda()
    rs = torch.from_numpy(rng.uniform(1e-3, 1e-1, 64).astype(np.float32))
    rs = rs.to(torch.bfloat16).float().cuda()
    sink = torch.empty(BLOCKS * 128, device="cuda")
    results = []
    for var, name in enumerate(NAMES):
        out = torch.empty((len(s), 256), device="cuda")
        if fn(var, 0, xs.data_ptr(), ss.data_ptr(), len(s), out.data_ptr(), stream):
            sys.exit(f"candidate {var} did not launch")
        got = out.cpu()
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        times = []
        for _ in range(8):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if fn(var, BLOCKS, rows.data_ptr(), rs.data_ptr(), ITERS,
                  sink.data_ptr(), stream):
                sys.exit(f"candidate {var} did not launch")
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times[1:]))
        results.append({"variant": var, "name": name, "mismatches": bad,
                        "values": got.numel(), "ms": ms,
                        "gvalues_per_s": BLOCKS * 128 * ITERS * 8 / ms / 1e6})
        print(f"[dequant] {var} {name}: {bad} of {got.numel()} values differ "
              f"from dequantize_ref; loop {ms:.4f} ms, "
              f"{results[-1]['gvalues_per_s']:.1f} G values/s ({card})", flush=True)
    print(json.dumps({"dequant_bench": results, "card": card,
                      "scales": len(s)}))


if __name__ == "__main__":
    main()
