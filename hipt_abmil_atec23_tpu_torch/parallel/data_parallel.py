"""Data-parallel region encoding over a mesh's ``data`` axis.

Counterpart of the JAX package's ``jax.jit(hipt.apply)`` on regions
sharded over a ``data`` mesh (``__graft_entry__.py`` :140-158): each rank
encodes its own contiguous block of the regions and the features are
all-gathered in rank order, so every rank holds all of them. As with
``NamedSharding`` in JAX, a region count that does not divide over the
ranks raises; nothing is padded.
"""
from __future__ import annotations

import torch

from hipt_abmil_atec23_tpu_torch.engine.stacked import (
    gather_lanes, lane_block)


def encode_data_parallel(model, regions: torch.Tensor, mesh
                         ) -> torch.Tensor:
    """[R, H, W, 3] normalised regions -> [R, D4k] f32 features of
    ``model`` (a ``models.hipt.HIPT4K``) on every rank of ``mesh``'s
    ``data`` axis. Each rank copies to the model's device and encodes only its
    block ``[r R / W, (r + 1) R / W)``; raises ValueError when R does not
    divide over the W ranks."""
    rows = lane_block(regions.shape[0], mesh, ("data",))
    device = next(model.parameters()).device
    local = regions[rows.start:rows.stop].to(device, non_blocking=True)
    with torch.no_grad():
        feats = model(local).float()
    return gather_lanes(feats, mesh, ("data",))
