"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``) and
is compiled on first use into ``build/lib<name>-<hash>.so`` beside this
file (the directory is git-ignored; the hash of the source and of the
shared headers ``csrc/*.cuh`` names the library, so an edited source or
header is never served by a stale build).  No PyTorch headers are
included, which keeps one build to seconds instead of the minutes
``torch.utils.cpp_extension`` takes.  Only sources in
this package are built, and a failed build raises.

    from repro_torch.kernels import _build
    lib = _build.load("flash_decode_paged")       # builds if needed
    logs = _build.build_all(_build.SOURCES, verbose=True)  # parallel nvcc
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
# every kernel source, csrc/<name>.cu
SOURCES = ("flash_decode_paged", "probe_topk", "ivf_topk", "flash_decode",
           "centroid_scores", "flash_decode_spliced", "flash_decode_quant",
           "mla_decode")

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    """The nvcc binary: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises ``KernelBuildError`` when absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "CUDA kernels are built only on a CUDA host")


def _source(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    return src


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes (keyed by the content
    of the source and of every header it may include)."""
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path, verbose: bool) -> list:
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(_source(name))]


def build_all(names: Sequence[str], *, verbose: bool = False,
              force: bool = False) -> Dict[str, str]:
    """Compile every named source that has no current build, one nvcc
    process per source, all started together.  Returns the compiler's
    output by name (ptxas register/shared-memory/spill lines when
    ``verbose``).  Raises ``KernelBuildError`` naming every failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)          # atomic: concurrent builders race safely
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
