"""ResNet50-trunc in plain PyTorch (mahmoodlab/CLAM models/resnet_custom.py
resnet50_baseline: torchvision's ResNet-50 stem and layers 1-3, the stride
on each stage's first 3x3, global average pooling to 1024-d). BatchNorm
runs unfolded from its running statistics (eval mode, eps 1e-5). Weights
are a state dict in torchvision's layout; f32 throughout, ``precision``
rounding the convolutions' operands for a control."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.precision import conv2d


def _bn(x, w, name):
    return F.batch_norm(x, w[f"{name}.running_mean"],
                        w[f"{name}.running_var"], w[f"{name}.weight"],
                        w[f"{name}.bias"], False, 0.0, 1e-5)


def resnet_trunk(x: torch.Tensor, w: Dict[str, torch.Tensor], enc: dict,
                 prec: str = "f32") -> torch.Tensor:
    """Normalised patches [B, H, W, 3] -> features [B, 4 * width * 2^(stages
    - 1)]."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_bn(conv2d(x, w["conv1.weight"], None, 2, 3, prec), w, "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for si, blocks in enumerate(enc["layers"]):
        for bi in range(blocks):
            p = f"layer{si + 1}.{bi}."
            stride = 2 if si > 0 and bi == 0 else 1
            out = F.relu(_bn(conv2d(x, w[p + "conv1.weight"], None, 1, 0,
                                    prec), w, p + "bn1"))
            out = F.relu(_bn(conv2d(out, w[p + "conv2.weight"], None, stride,
                                    1, prec), w, p + "bn2"))
            out = _bn(conv2d(out, w[p + "conv3.weight"], None, 1, 0, prec),
                      w, p + "bn3")
            if bi == 0:
                x = _bn(conv2d(x, w[p + "downsample.0.weight"], None, stride,
                               0, prec), w, p + "downsample.1")
            x = F.relu(out + x)
    return x.mean((2, 3))


def resnet(patches: torch.Tensor, w: Dict[str, torch.Tensor], enc: dict,
           prec: str = "f32", block: int = 64) -> torch.Tensor:
    """Blocks of ``block`` patches at a time."""
    return torch.cat([resnet_trunk(patches[i:i + block], w, enc, prec)
                      for i in range(0, len(patches), block)])
