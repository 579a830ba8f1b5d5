"""Seeded weights for a configuration, made on the device in one draw.

Each model is a list of leaves (name, shape, kind) worked out from the
configuration's widths, in the published checkpoints' layouts: DINO's for
HIPT_4K (``vit256.`` / ``vit4k.`` prefixes), torchvision's for the ResNet
trunk, CLAM's for the head. One ``torch.randn`` on the device gives every
leaf its share, and the leaf's kind scales it. The program loads these
tensors as a state dict and the plain reference reads the same ones, so
both start from the same weights; neither side draws its own.

Every leaf is random, biases and normalisation parameters included, so the
comparison that decides ``correct`` reaches each of them, and the ViTs'
Linear weights are spread as a trained model's are, so that each region's
feature depends on its pixels.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]


def _linear(name: str, fan_out: int, fan_in: int, kind: str = "lin",
            bias: str = "b") -> List[Leaf]:
    return [(f"{name}.weight", (fan_out, fan_in), kind),
            (f"{name}.bias", (fan_out,), bias)]


def _norm(name: str, dim: int) -> List[Leaf]:
    return [(f"{name}.weight", (dim,), "ln_w"), (f"{name}.bias", (dim,), "b")]


def _blocks(prefix: str, depth: int, dim: int, mlp_ratio: float
            ) -> List[Leaf]:
    hidden = int(dim * mlp_ratio)
    out: List[Leaf] = []
    for i in range(depth):
        p = f"{prefix}blocks.{i}."
        out += _norm(p + "norm1", dim)
        out += _linear(p + "attn.qkv", 3 * dim, dim)
        out += _linear(p + "attn.proj", dim, dim)
        out += _norm(p + "norm2", dim)
        out += _linear(p + "mlp.fc1", hidden, dim)
        out += _linear(p + "mlp.fc2", dim, hidden)
    return out


def hipt4k_leaves(enc: dict) -> List[Leaf]:
    v, w = enc["vit256"], enc["vit4k"]
    d, p = v["embed_dim"], v["patch_size"]
    slots = (v["pretrain_img_size"] // p) ** 2 + 1
    out: List[Leaf] = [
        ("vit256.patch_embed.proj.weight", (d, 3, p, p), "conv_in"),
        ("vit256.patch_embed.proj.bias", (d,), "b"),
        ("vit256.cls_token", (1, 1, d), "w"),
        ("vit256.pos_embed", (1, slots, d), "w")]
    out += _blocks("vit256.", v["depth"], d, v["mlp_ratio"])
    out += _norm("vit256.norm", d)
    d4 = w["output_embed_dim"]
    out += _linear("vit4k.phi.0", d4, w["input_embed_dim"])
    out += [("vit4k.cls_token", (1, 1, d4), "w"),
            ("vit4k.pos_embed", (1, w["pretrain_grid"] ** 2 + 1, d4), "w")]
    out += _blocks("vit4k.", w["depth"], d4, w["mlp_ratio"])
    out += _norm("vit4k.norm", d4)
    return out


def _bn(name: str, c: int) -> List[Leaf]:
    return [(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
            (f"{name}.running_mean", (c,), "bn_b"),
            (f"{name}.running_var", (c,), "bn_w"),
            (f"{name}.num_batches_tracked", (), "count")]


def resnet_leaves(enc: dict) -> List[Leaf]:
    w = enc["stem_width"]
    out: List[Leaf] = [("conv1.weight", (w, 3, 7, 7), "conv_out")]
    out += _bn("bn1", w)
    cin, planes = w, w
    for si, blocks in enumerate(enc["layers"]):
        for bi in range(blocks):
            p = f"layer{si + 1}.{bi}."
            for k, (ci, co, ks) in enumerate(
                    ((cin, planes, 1), (planes, planes, 3),
                     (planes, planes * 4, 1)), 1):
                out.append((f"{p}conv{k}.weight", (co, ci, ks, ks),
                            "conv_out"))
                out += _bn(f"{p}bn{k}", co)
            if bi == 0:
                out.append((f"{p}downsample.0.weight", (planes * 4, cin, 1, 1),
                            "conv_out"))
                out += _bn(f"{p}downsample.1", planes * 4)
            cin = planes * 4
        planes *= 2
    return out


def clam_leaves(head: dict) -> List[Leaf]:
    d_in, l_dim, d_att = head["size"]
    c = head["n_classes"]
    def lin(name, fan_out, fan_in):
        return _linear(name, fan_out, fan_in, "xavier", "head_b")

    s = "attention_net.2."
    out = lin("attention_net.0", l_dim, d_in)
    out += lin(s + "attention_a.0", d_att, l_dim)
    out += lin(s + "attention_b.0", d_att, l_dim)
    out += lin(s + "attention_c", 1, d_att)
    out += lin("classifiers", c, l_dim)
    for i in range(c):
        out += lin(f"instance_classifiers.{i}", 2, l_dim)
    return out


ENCODER_LEAVES = {"hipt4k": hipt4k_leaves, "resnet": resnet_leaves}


def _scaled(kind: str, shape, z: torch.Tensor) -> torch.Tensor:
    if kind == "count":
        return torch.zeros(shape, dtype=torch.long, device=z.device)
    z = z.view(shape).clamp(-2.0, 2.0)
    if kind == "w":            # DINO's truncated normal, std 0.02
        return z * 0.02
    if kind == "lin":          # a trained ViT's spread, not DINO's init:
        # at 0.02 the CLS barely depends on the pixels (two regions'
        # features 1-2% apart, the bf16 path 0.7% off the reference); at
        # 0.08 regions lie 9-14% apart and the bf16 path stays ~1% off
        return z * 0.08
    if kind == "b":
        return z * 0.02
    if kind == "head_b":       # the reference CLAM heads' trained biases
        return z * 0.1         # are far from zero
    if kind == "ln_w":
        return 1.0 + 0.1 * z
    if kind == "conv_in":      # a Linear over the patch's fan-in
        return z * (shape[1] * shape[2] * shape[3]) ** -0.5
    if kind == "conv_out":     # kaiming normal, fan_out, relu
        return z * (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5
    if kind == "bn_w":         # scales and variances in 0.5 .. 1.5
        return 1.0 + 0.25 * z
    if kind == "bn_b":
        return 0.1 * z
    if kind == "xavier":
        return z * (2.0 / (shape[0] + shape[1])) ** 0.5
    raise ValueError(f"unknown leaf kind {kind!r}")


def make_weights(leaves: List[Leaf], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The leaves' f32 tensors on ``device`` from one seeded draw."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [max(1, int(torch.Size(s).numel())) for _, s, _ in leaves]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        z = flat[at:at + n]
        at += n
        out[name] = _scaled(kind, shape, z).contiguous()
    return out


def encoder_weights(config: dict, seed: int, device) -> Dict[str,
                                                             torch.Tensor]:
    enc = config["encoder"]
    return make_weights(ENCODER_LEAVES[enc["kind"]](enc), seed, device)


def head_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The head's weights, from a seed of their own beside the encoder's."""
    return make_weights(clam_leaves(config["head"]), seed ^ 0x5EED, device)
