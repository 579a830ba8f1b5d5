"""Seeded weights and tile embeddings of the Prov-GigaPath slide-encoder
configuration, made on the device.

The weights are one seeded ``torch.randn`` in the published state dict's
layout (``slide_encoder.``, ``classifier.0.``), as port_bench/weights.py
draws the other configurations': every leaf random, biases and
LayerNorm parameters included. The encoder's Linear weights take the
configuration's ``model.weight_std`` (PERF.md section 4 says why), the
head Xavier's.

The tile embeddings stand in for the ViT-g tile encoder's: a pool of
1536-d f32 rows drawn from the seed, with the pool cut into runs of
``run_rows`` rows (a tissue region's tiles lie together in a bag) that
each take one of ``classes`` seeded class means, a per-run offset and
per-row noise, so that slides (contiguous windows of the pool) differ in
their mix of tissue as real slides do.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from port_bench.weights import Leaf, _linear, _norm, _scaled


def gigapath_leaves(m: dict) -> List[Leaf]:
    d, hidden = m["embed_dim"], int(m["embed_dim"] * m["mlp_ratio"])
    e = "slide_encoder."
    out: List[Leaf] = _linear(e + "patch_embed.proj", d, m["in_chans"],
                              "enc")
    out.append((e + "cls_token", (1, 1, d), "w"))
    for i in range(m["depth"]):
        p = f"{e}encoder.layers.{i}."
        out += _norm(p + "self_attn_layer_norm", d)
        for t in "qkv":
            out += _linear(f"{p}self_attn.{t}_proj", d, d, "enc")
        out += _norm(p + "self_attn.inner_attn_ln", d)
        out += _linear(p + "self_attn.out_proj", d, d, "enc")
        out += _norm(p + "final_layer_norm", d)
        out += _linear(p + "ffn.fc1", hidden, d, "enc")
        out += _norm(p + "ffn.ffn_layernorm", hidden)
        out += _linear(p + "ffn.fc2", d, hidden, "enc")
    out += _norm(e + "encoder.layer_norm", d)
    out += _norm(e + "norm", d)
    out += _linear("classifier.0", m["n_classes"], d, "xavier", "head_b")
    return out


def gigapath_weights(config: dict, seed: int, device
                     ) -> Dict[str, torch.Tensor]:
    """The configuration's f32 weights on ``device`` from one draw."""
    m = config["model"]
    leaves = gigapath_leaves(m)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [max(1, int(torch.Size(s).numel())) for _, s, _ in leaves]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        z = flat[at:at + n]
        at += n
        if kind == "enc":
            out[name] = (z.view(shape).clamp(-2.0, 2.0)
                         * m["weight_std"]).contiguous()
        else:
            out[name] = _scaled(kind, shape, z).contiguous()
    return out


def tile_pool(traffic: dict, dim: int, seed: int, device,
              chunk: int = 4096) -> torch.Tensor:
    """[pool_rows, dim] f32 tile embeddings in pinned host memory, drawn on
    ``device`` from ``seed`` (a stream of its own beside the weights')."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x7111E)
    rows, run = traffic["pool_rows"], traffic["run_rows"]
    means = torch.randn(traffic["classes"], dim, generator=gen,
                        device=device)
    n_runs = -(-rows // run)
    cls = torch.randint(0, traffic["classes"], (n_runs,), generator=gen,
                        device=device)
    offset = torch.randn(n_runs, dim, generator=gen, device=device) \
        * traffic["run_std"]
    pool = torch.empty(rows, dim, pin_memory=device.type == "cuda")
    for i in range(0, rows, chunk):
        k = min(chunk, rows - i)
        r = torch.arange(i, i + k, device=device) // run
        x = means[cls[r]] + offset[r] + traffic["row_std"] * torch.randn(
            k, dim, generator=gen, device=device)
        pool[i:i + k].copy_(x)
    return pool
