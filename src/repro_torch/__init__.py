"""PyTorch/CUDA port of the TeleRAG serving stack.

Mirrors the module paths of the JAX package ``repro`` (which stays the
reference it is tested against) and imports nothing of it.  Every entry
point takes ``device`` (default ``"cuda"``); the default raises on a host
without a card instead of carrying on on the CPU.  Kernel wrappers
dispatch by the tensor's device alone: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the hand-written kernel.

Subpackages keep their ``__init__`` free of imports, so importing one
module never drags in (or cycles through) the others.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is
    asked for and none is present (never a silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev
