"""Stacked MIL heads: many heads as one leading axis under ``torch.func``.

Fold-parallel training (parallel/fold_parallel.py) and trial-parallel
tuning (engine/tune_parallel.py) train F folds or T trials of one head
architecture at once. Where the JAX package ``vmap``s flax's ``apply`` over
a stacked parameter tree, the port stacks the heads' parameters
(``torch.func.stack_module_state``) and ``vmap``s ``functional_call`` of one
head, with ``torch.func.grad`` for the step. The heads' forwards are plain
torch ops (no custom kernel: a CUDA extension op has no batching rule), so
every lane runs the same head code as ``train_fold``.

Over a ``DeviceMesh``'s ``fold`` axis each rank holds a contiguous block of
the lanes (``lane_block``) and ``gather_lanes`` all-gathers per-lane values.
``axes`` names the mesh axes the lanes split over, ``("fold",)`` by
default; several axes split them over every rank of those axes in rank
order, as JAX's ``P(("host", "fold"))`` does on a 2-D mesh.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

import torch
from torch.func import functional_call, grad, stack_module_state, vmap

from hipt_abmil_atec23_tpu_torch.engine.losses import (
    make_bag_loss, make_per_sample_loss)


def stack_heads(models: List[torch.nn.Module]
                ) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(a parameterless copy of the head to call, its parameters stacked
    along a new leading axis as leaf tensors that require grad)."""
    params, _ = stack_module_state(models)
    base = copy.deepcopy(models[0]).to("meta")
    return base, params


def unstack(params: Dict[str, torch.Tensor], i: int
            ) -> Dict[str, torch.Tensor]:
    """Lane ``i``'s state dict (detached copies)."""
    return {k: v[i].detach().clone() for k, v in params.items()}


def head_fns(base: torch.nn.Module, cfg, class_counts
             ) -> Tuple[Callable, Callable]:
    """(step, evaluate) for one lane, to be vmapped over stacked params.

    ``step(p, feats [B, N, D], mask, labels, generator)`` -> (gradients,
    (bag loss, instance loss, accuracy)): the loss of engine/train.py's
    train_epoch, bag_weight * bag loss + (1 - bag_weight) * instance loss
    where the instance loss is on, with dropout from ``generator``.
    ``evaluate(p, feats, mask, labels)`` -> (probs [B, C], per-slide loss
    [B]) of the deterministic forward, the loss the configured one as in
    train.py's eval_batch."""
    mc = cfg.model
    is_clam = mc.model_type in ("clam_sb", "clam_mb")
    use_inst = is_clam and not mc.no_inst_cluster
    bag_loss = make_bag_loss(cfg.train.bag_loss, class_counts)
    per_slide = make_per_sample_loss(cfg.train.bag_loss)
    bag_weight = cfg.train.bag_weight

    def forward(p, feats, mask, labels, deterministic, generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        if is_clam:
            kw.update(label=labels, instance_eval=use_inst)
        return functional_call(base, p, (feats, mask), kw)

    def loss(p, feats, mask, labels, generator):
        out = forward(p, feats, mask, labels, False, generator)
        bl = bag_loss(out.logits, labels)
        if use_inst:
            inst = out.extras["instance_loss"].mean()
            total = bag_weight * bl + (1.0 - bag_weight) * inst
        else:
            inst = torch.zeros((), device=bl.device)
            total = bl
        correct = (out.y_hat == labels).float().mean()
        return total, (bl.detach(), inst.detach(), correct)

    def evaluate(p, feats, mask, labels):
        out = forward(p, feats, mask, labels, True)
        return torch.softmax(out.logits, dim=-1), per_slide(out.logits,
                                                            labels)

    return grad(loss, has_aux=True), evaluate


def vmap_lanes(fn: Callable, in_dims) -> Callable:
    """``fn`` over the lanes; each lane draws its own dropout masks."""
    return vmap(fn, in_dims=in_dims, randomness="different")


def step_lanes(step_f, params: List[torch.Tensor], names: List[str],
               optimizer, feats: torch.Tensor, mask: torch.Tensor,
               labels: torch.Tensor, generator) -> torch.Tensor:
    """One epoch's optimizer steps on every lane: ``step_f`` (the vmapped
    step of ``head_fns``) over ``feats`` [F, S, B, N, D] (mask, labels
    alike) step by step, ``optimizer`` on the stacked leaves ``params``
    (named ``names``). Returns each lane's bag loss summed over the S
    steps [F]."""
    sums = torch.zeros(feats.shape[0], device=feats.device)
    for s in range(feats.shape[1]):
        grads, (bl, _, _) = step_f(dict(zip(names, params)), feats[:, s],
                                   mask[:, s], labels[:, s], generator)
        for p, name in zip(params, names):
            p.grad = grads[name]
        optimizer.step()
        sums += bl
    return sums


def _lane_group(mesh, axes=("fold",)):
    """(process group, size, this rank's index) of the ranks that split the
    lanes: one axis's group, or for several axes the whole default group,
    which must be what the mesh covers with ``axes`` its dimensions in
    order (torch has no group over a subset of a mesh's axes here)."""
    import torch.distributed as dist
    axes = tuple(axes)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        return group, dist.get_world_size(group), dist.get_rank(group)
    if axes != tuple(mesh.mesh_dim_names) \
            or mesh.size() != dist.get_world_size():
        raise ValueError(f"lanes split over {axes} need a mesh of exactly "
                         f"those axes over every rank, got "
                         f"{mesh.mesh_dim_names} of {mesh.size()} of "
                         f"{dist.get_world_size()} ranks")
    return None, dist.get_world_size(), dist.get_rank()


def lane_block(n: int, mesh, axes=("fold",)) -> range:
    """The lanes this rank holds: all of them without a mesh, else its
    contiguous n / W of them along the mesh's ``axes``."""
    if mesh is None:
        return range(n)
    _, w, r = _lane_group(mesh, axes)
    if n % w:
        raise ValueError(f"{n} lanes do not divide over {w} ranks")
    return range(r * n // w, (r + 1) * n // w)


def gather_lanes(x: torch.Tensor, mesh, axes=("fold",)) -> torch.Tensor:
    """Every rank's [n_local, ...] block gathered in rank order along the
    mesh's ``axes`` ([n, ...] on every rank); ``x`` itself without a
    mesh."""
    if mesh is None:
        return x
    import torch.distributed as dist
    group, w, _ = _lane_group(mesh, axes)
    parts = [torch.empty_like(x) for _ in range(w)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def gather_objects(obj, mesh) -> list:
    """Every rank's ``obj`` in rank order along the ``fold`` axis
    (``[obj]`` without a mesh)."""
    if mesh is None:
        return [obj]
    import torch.distributed as dist
    group, w, _ = _lane_group(mesh)
    out = [None] * w
    dist.all_gather_object(out, obj, group=group)
    return out
