"""The yardstick's arithmetic: the card's peaks and the operations and
bytes of the work each cell runs, worked out from the shapes in a
configuration, never from what a kernel does.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at the 700 W
limit). Operations count
the matrix products and convolutions (2 per multiply-add) and the
attention products; normalisations and activations are left out.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12


def least_seconds(nbytes: float, flops: float, peak: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory rate and the operations at ``peak``."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


# ------------------------------------------------------------------ ViT
def padded_tokens(n: int) -> int:
    """Tokens as the fused block takes them: padded to a multiple of 8."""
    return (n + 7) // 8 * 8


def vit_block_flops(n_valid: int, dim: int, mlp_ratio: float) -> float:
    """One pre-norm block over ``n_valid`` tokens: qkv, proj, fc1 and fc2
    (2 n d (3d + d + 2 r d)) and the two attention products (4 n^2 d)."""
    hidden = int(dim * mlp_ratio)
    return (2.0 * n_valid * dim * (4 * dim + 2 * hidden)
            + 4.0 * n_valid * n_valid * dim)


def vit_block_bytes(images: int, n_pad: int, dim: int,
                    mlp_ratio: float) -> float:
    """One block call on ``images`` padded token sets: bf16 tokens read and
    written once, the four GEMMs' bf16 weights read once."""
    hidden = int(dim * mlp_ratio)
    return (2.0 * images * n_pad * dim * 2
            + 2.0 * dim * (4 * dim + 2 * hidden))


def hipt_shapes(enc: dict) -> Dict[str, int]:
    """Token and tile counts of one HIPT_4K region."""
    v256, v4k = enc["vit256"], enc["vit4k"]
    tiles_side = enc["region_size"] // enc["tile_size"]
    patches_side = enc["tile_size"] // v256["patch_size"]
    return {"tiles": tiles_side ** 2,
            "tokens256": patches_side ** 2 + 1,
            "tokens4k": tiles_side ** 2 + 1}


def hipt_block_calls(enc: dict, regions: int) -> List[Tuple[int, int, int,
                                                            int, float]]:
    """The ViT blocks that ``regions`` regions run, grouped as calls:
    (images, n_valid, n_pad, dim, mlp_ratio) per block call."""
    s = hipt_shapes(enc)
    v256, v4k = enc["vit256"], enc["vit4k"]
    calls = [(regions * s["tiles"], s["tokens256"],
              padded_tokens(s["tokens256"]), v256["embed_dim"],
              v256["mlp_ratio"])] * v256["depth"]
    calls += [(regions, s["tokens4k"], padded_tokens(s["tokens4k"]),
               v4k["output_embed_dim"], v4k["mlp_ratio"])] * v4k["depth"]
    return calls


def hipt_blocks_least_seconds(enc: dict, regions: int) -> float:
    """The least time of every block of ``regions`` regions, each call at
    the bf16 peak or the memory rate."""
    return sum(least_seconds(vit_block_bytes(b, n_pad, d, r),
                             b * vit_block_flops(nv, d, r), BF16_FLOP_S)
               for b, nv, n_pad, d, r in hipt_block_calls(enc, regions))


def hipt_region_flops(enc: dict) -> float:
    """One region through HIPT_4K: ViT-256's patch embedding and blocks on
    every tile, then ViT-4K's phi and blocks on the CLS grid."""
    s = hipt_shapes(enc)
    v256, v4k = enc["vit256"], enc["vit4k"]
    p = v256["patch_size"]
    embed = 2.0 * (s["tokens256"] - 1) * p * p * 3 * v256["embed_dim"]
    vit256 = s["tiles"] * (embed + v256["depth"] * vit_block_flops(
        s["tokens256"], v256["embed_dim"], v256["mlp_ratio"]))
    phi = 2.0 * s["tiles"] * v4k["input_embed_dim"] * v4k["output_embed_dim"]
    vit4k = phi + v4k["depth"] * vit_block_flops(
        s["tokens4k"], v4k["output_embed_dim"], v4k["mlp_ratio"])
    return vit256 + vit4k


# --------------------------------------------------------------- ResNet
def conv_flops(cin: int, cout: int, k: int, hout: int, wout: int) -> float:
    return 2.0 * cin * cout * k * k * hout * wout


def resnet_patch_flops(enc: dict) -> float:
    """One patch through a bottleneck ResNet trunk: the 7x7 stem (stride
    2), a 3x3 stride-2 max pool, then per stage the bottlenecks (1x1, 3x3
    with the stage's stride on the first block, 1x1 to 4x the width, and a
    1x1 projection on the first block)."""
    size = enc["patch_size"]
    w = enc["stem_width"]
    h = (size + 2 * 3 - 7) // 2 + 1
    flops = conv_flops(3, w, 7, h, h)
    h = (h + 2 - 3) // 2 + 1
    cin, planes = w, w
    for si, blocks in enumerate(enc["layers"]):
        for bi in range(blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            hout = (h + 2 - 3) // stride + 1
            flops += conv_flops(cin, planes, 1, h, h)
            flops += conv_flops(planes, planes, 3, hout, hout)
            flops += conv_flops(planes, planes * 4, 1, hout, hout)
            if bi == 0:
                flops += conv_flops(cin, planes * 4, 1, hout, hout)
            cin, h = planes * 4, hout
        planes *= 2
    return flops


# ----------------------------------------------------------------- head
def clam_flops(size: Iterable[int], n_classes: int, n: int) -> float:
    """CLAM_SB's gated attention over ``n`` instances: fc, the two gate
    branches, the scorer and the weighted sum, then the classifier."""
    d_in, l_dim, d_att = size
    return (n * (2.0 * d_in * l_dim + 4.0 * l_dim * d_att + 2.0 * d_att
                 + 2.0 * l_dim) + 2.0 * l_dim * n_classes)
