"""Instance-axis (sequence-parallel) sharded MIL on torch.distributed.

Counterpart of hipt_abmil_atec23_tpu/parallel/sharded_bag.py. A full slide
bag (10^4-10^5 x 1024 for ResNet features) is split along its instance axis:
each rank of a mesh axis holds its own rows [N / W, D] and their validity
mask. The gated-attention softmax runs as local partials plus collectives
over the axis (global max, global sums), and the bag embedding is a sum of
local weighted sums, so inference and training see every instance.

Gradients. Every rank computes the same replicated loss, and the sum over
ranks (``_AllReduceSum``, like torch.distributed.nn's ``all_reduce``) sums
the incoming gradient over ranks in its backward, so a plain
``loss.backward()`` on each rank would give the shard-local parameter
contributions W times and the classifier gradient once per rank. ``sharded_bag_train_step`` follows DDP's rule: each rank
backpropagates loss / W, then the parameter gradients are summed over the
axis, which counts every shard's contribution once and the classifier once.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from hipt_abmil_atec23_tpu_torch.ops.masking import NEG_INF


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the gradient too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The axis's rows in rank order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts)


def sharded_clam_forward(model, bag_local: torch.Tensor,
                         mask_local: torch.Tensor, mesh, *, axis: str = "inst",
                         use_fused: bool = False, fused_impl: str = "grid"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLAM_SB deterministic forward with the instance axis sharded over
    ``mesh``'s ``axis``. ``bag_local`` [N / W, D] and ``mask_local``
    [N / W] bool are this rank's rows; every rank of the axis holds the
    same number. Returns (logits [1, C], a_raw [1, N]), the same on every
    rank.

    ``use_fused=True`` runs each shard's projection and online-softmax
    partials as one kernel launch (``gated_attention_pool_partial``) and
    combines the shards with ``combine_partials`` after a max and one
    packed sum over the axis. It is inference only: the kernel has no
    backward. ``fused_impl`` is passed on as the kernel's ``impl``."""
    group = mesh.get_group(axis)
    if use_fused:
        from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
            combine_partials, gated_attention_pool_partial, params_from_clam)
        gp = params_from_clam(model)
        with torch.no_grad():
            acc, m, l, scores = gated_attention_pool_partial(
                bag_local, gp, mask=mask_local, impl=fused_impl)
            gmax = m.clone()
            dist.all_reduce(gmax, dist.ReduceOp.MAX, group=group)
            scale = torch.exp(m - gmax)
            packed = torch.cat([(l * scale)[None], acc[0] * scale])
            dist.all_reduce(packed, group=group)
            logits = combine_partials(packed[None, 1:], gmax[None],
                                      packed[:1], gp)
            return logits, _gather_rows(scores, group)[None, :]

    fc, attn = model.attention_net[0], model.attention_net[-1]
    h = torch.relu(fc(bag_local))                             # [n, L]
    scores = attn(h)[:, 0]
    scores = torch.where(mask_local, scores, torch.full_like(scores, NEG_INF))
    # softmax(s - c) is invariant in c: the global max is only a shift for
    # stability, so it carries no gradient
    gmax = scores.detach().max()
    dist.all_reduce(gmax, dist.ReduceOp.MAX, group=group)
    e = torch.exp(scores - gmax) * mask_local.to(scores.dtype)
    gsum = _AllReduceSum.apply(e.sum(), group)
    w = e / torch.clamp(gsum, min=1e-30)
    m = _AllReduceSum.apply(w @ h, group)                     # [L]
    logits = model.classifiers(m)[None, :]
    return logits, _gather_rows(scores, group)[None, :]


def sharded_clam_loss(model, bag_local: torch.Tensor,
                      mask_local: torch.Tensor, label, mesh, *,
                      axis: str = "inst") -> torch.Tensor:
    """Cross-entropy bag loss on an instance-sharded bag, the same on every
    rank. Its gradient through the collectives follows the rule in the
    module docstring; ``sharded_bag_train_step`` applies it."""
    logits, _ = sharded_clam_forward(model, bag_local, mask_local, mesh,
                                     axis=axis)
    return -torch.log_softmax(logits[0], dim=-1)[int(label)]


def sharded_bag_train_step(model, optimizer: torch.optim.Optimizer,
                           bag_local: torch.Tensor, mask_local: torch.Tensor,
                           label, mesh, *, axis: str = "inst"
                           ) -> torch.Tensor:
    """One optimizer step on one full bag with the instance axis sharded.
    Each rank's parameter gradients equal the unsharded bag's gradient
    before the step, so the replicas stay in lockstep. Returns the loss
    (detached)."""
    group = mesh.get_group(axis)
    world = dist.get_world_size(group)
    optimizer.zero_grad(set_to_none=True)
    loss = sharded_clam_loss(model, bag_local, mask_local, label, mesh,
                             axis=axis)
    (loss / world).backward()
    params = [p for p in model.parameters() if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))
    optimizer.step()
    return loss.detach()
