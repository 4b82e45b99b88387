"""Production mesh definitions on H100s (the reference's
``launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (never a module-level constant)
and returns a ``distributed.sharding.MeshAxes``, names and sizes alone:
importing this module or building the mesh touches no CUDA and no
process-group state, so the dry run plans cells for cards it does not
have.

Topology: the reference's device counts, so cells compare one to one.
256 cards as ``("data", "model") = (32, 8)``; the multi-pod mesh stacks
a ``pod`` axis, ``(2, 32, 8)`` = 512 cards, used for data parallelism
only.  ``model`` is 8 because one node holds 8 H100s joined by NVLink:
tensor parallelism past 8 would leave NVLink for the node's NICs.
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.distributed.sharding import MeshAxes

SINGLE_POD, MULTI_POD = "h100x32x8", "h100x2x32x8"


def mesh_name(multi_pod: bool = False) -> str:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False) -> MeshAxes:
    if multi_pod:
        return MeshAxes(("pod", "data", "model"), (2, 32, 8))
    return MeshAxes(("data", "model"), (32, 8))


def make_host_mesh(model: int = 1, data: Optional[int] = None):
    """A ``("data", "model")`` ``DeviceMesh`` over the initialised world
    (tests / examples): gloo ranks on the CPU, NCCL ranks on cards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    data = data or max(n // model, 1)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_chip_count(mesh) -> int:
    """Cards in a ``MeshAxes`` or a ``DeviceMesh``."""
    return math.prod(tuple(mesh.shape))
