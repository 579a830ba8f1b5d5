"""Mesh construction.

Counterpart of hipt_abmil_atec23_tpu/parallel/mesh.py on
``torch.distributed.device_mesh``. The axes keep the JAX package's names:

- ``fold`` — cross-validation folds;
- ``data`` — bags or patches within a fold;
- ``inst`` — instances within one giant bag (sequence parallelism for
  full-slide MIL).

Collectives run through the process group of an axis (NCCL on CUDA, gloo on
the CPU). The JAX package's ``fold_sharding`` and ``replicated`` build
``NamedSharding``s for arrays that one program places over many devices;
torch has no global array to place, since each rank holds its own tensors, so
they have no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axis_sizes: Optional[Sequence[Tuple[str, int]]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the default process group (set up first,
    e.g. by ``parallel.multihost.init_multihost``). Default: all ranks on a
    single 'fold' axis. Raises ValueError when the axis sizes do not
    multiply to the world size."""
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [("fold", world)]
    names = tuple(n for n, _ in axis_sizes)
    sizes = tuple(int(s) for _, s in axis_sizes)
    total = 1
    for s in sizes:
        total *= s
    if total != world:
        raise ValueError(f"mesh {list(axis_sizes)} needs {total} devices, "
                         f"got {world}")
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)
