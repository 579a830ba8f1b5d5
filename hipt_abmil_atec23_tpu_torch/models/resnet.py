"""Frozen ResNet patch encoders.

Counterpart of hipt_abmil_atec23_tpu/models/resnet.py: ``resnet50_trunc``
is ResNet-50 minus layer4 with global average pooling, 1024-d features
(reference: models/resnet_custom.py:58-110, 138-149); ``resnet18`` is the
whole ResNet-18 trunk with its fc head stripped, 512-d (:112-135).

The modules keep the reference's and torchvision's parameter names
(``conv1``, ``bn1``, ``layerN.i.convK`` / ``bnK``, ``layerN.i.downsample.0``
/ ``.1``), so a reference ``.pth`` loads with ``load_resnet_``. Inputs are
NHWC, as in the JAX package; inside, the activations are channels_last
(the NHWC tensor's own memory) and the convolutions are cuDNN's: the JAX
package leaves them to XLA, no Pallas kernel is involved.

BatchNorm always runs with its running statistics (the encoder is frozen;
reference: hipt_model_utils.py:55-57, extract_features_fp.py:216), folded
into each convolution's weight and bias at first use in the compute dtype.
The fold is recomputed when a parameter or statistic changes (its version
counter or storage moves). In f32 it moves the features by float rounding
only (the CPU tests hold them to 1e-5 of the JAX package); in bf16 the
folded weights are rounded once, as the JAX package rounds its kernel.

Each convolution runs without its bias. One epilogue pass
(ops/conv_epilogue.py, a hand-written kernel on the card) then adds the
folded bias and, at a block's end, its residual (a downsample's output
with that convolution's folded bias), applies the ReLU, sums in f32 and
rounds once: 40 launches per ResNet50-trunc forward, 17 per ResNet-18.

f32 convolutions run in full f32 on the card: the forward turns cuDNN's
TF32 off around them (``torch.backends.cudnn.allow_tf32``, on by default
in PyTorch), so the f32 configuration is the precise one it says.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipt_abmil_atec23_tpu_torch.ops.conv_epilogue import conv_epilogue

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """torchvision's eval transform on uint8 (or 0..255 float) RGB
    [..., 3]: (x / 255 - mean) / std per channel, in f32 (reference:
    dataset_h5.py:21-37)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x.float() / 255.0 - mean) / std


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck, expansion 4 (reference:
    resnet_custom.py:20-56)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            _bn(planes * 4)) if downsample else None
        self.stride = stride

    def run(self, x, f, name):
        out = _conv_act(x, f[f"{name}.1"])
        out = _conv_act(out, f[f"{name}.2"], self.stride, 1)
        return _conv_act(out, f[f"{name}.3"], 1, 0,
                         *_shortcut(self, x, f, name))

    def pairs(self):
        yield "1", self.conv1, self.bn1
        yield "2", self.conv2, self.bn2
        yield "3", self.conv3, self.bn3
        if self.downsample is not None:
            yield "down", self.downsample[0], self.downsample[1]


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3 basic block (ResNet-18/34)."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=False),
            _bn(planes)) if downsample else None
        self.stride = stride

    def run(self, x, f, name):
        out = _conv_act(x, f[f"{name}.1"], self.stride, 1)
        return _conv_act(out, f[f"{name}.2"], 1, 1,
                         *_shortcut(self, x, f, name))

    def pairs(self):
        yield "1", self.conv1, self.bn1
        yield "2", self.conv2, self.bn2
        if self.downsample is not None:
            yield "down", self.downsample[0], self.downsample[1]


def _conv_act(x, wb, stride: int = 1, padding: int = 0, res=None,
              res_bias=None):
    """relu(conv(x) + b [+ (res [+ res_bias])]): the convolution without
    its folded bias (cuDNN on the card), then one epilogue pass."""
    return conv_epilogue(F.conv2d(x, wb[0], None, stride, padding),
                         wb[1], res, res_bias)


def _shortcut(blk, x, f, name):
    """(residual, its bias): the block's input, or its downsample
    convolution's bias-free output and folded bias, which the block's last
    epilogue adds."""
    if blk.downsample is None:
        return x, None
    w, b = f[f"{name}.down"]
    return F.conv2d(x, w, None, blk.stride), b


@contextlib.contextmanager
def _no_cudnn_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class ResNetTrunk(nn.Module):
    """Stem + layer1..layerN + global average pool: uint8-normalized NHWC
    [B, H, W, 3] -> [B, feat_dim] f32."""

    def __init__(self, block=Bottleneck, layers: Sequence[int] = (3, 4, 6),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        inplanes, planes = 64, 64
        for li, n_blocks in enumerate(self.layers):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if li > 0 and bi == 0 else 1
                down = bi == 0 and (stride != 1 or
                                    inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride, down))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.feat_dim = inplanes
        self._folded: Optional[Tuple[tuple, Dict]] = None

    @property
    def input_dtype(self) -> torch.dtype:
        return self.dtype

    def _blocks(self):
        for li in range(len(self.layers)):
            for bi, blk in enumerate(getattr(self, f"layer{li + 1}")):
                yield f"layer{li + 1}.{bi}", blk

    def _fold_key(self) -> tuple:
        return tuple((t.data_ptr(), -1 if t.is_inference() else t._version)
                     for t in self.state_dict(keep_vars=True).values())

    @torch.no_grad()
    def folded(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Every conv with its BatchNorm folded in: name -> (weight in the
        compute dtype, channels_last; bias)."""
        key = self._fold_key()
        if self._folded is not None and self._folded[0] == key:
            return self._folded[1]

        def fold(conv, bn):
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            w = conv.weight * scale[:, None, None, None]
            b = bn.bias - bn.running_mean * scale
            return (w.to(self.dtype).contiguous(
                memory_format=torch.channels_last), b.to(self.dtype))

        f = {"stem": fold(self.conv1, self.bn1)}
        for name, blk in self._blocks():
            for k, conv, bn in blk.pairs():
                f[f"{name}.{k}"] = fold(conv, bn)
        self._folded = (key, f)
        return f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.folded()
        # an NHWC tensor seen as NCHW is channels_last in memory
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        with _no_cudnn_tf32() if x.is_cuda else contextlib.nullcontext():
            x = _conv_act(x, f["stem"], 2, 3)
            x = F.max_pool2d(x, 3, 2, 1)
            for name, blk in self._blocks():
                x = blk.run(x, f, name)
        return x.mean((2, 3)).float()


def init_resnet_(model: ResNetTrunk, generator: torch.Generator
                 ) -> ResNetTrunk:
    """torchvision's initialisation from ``generator``: convs kaiming
    normal (fan_out, relu), BatchNorm weight 1, bias 0, running mean 0,
    variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                 generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def resnet50_trunc(dtype: torch.dtype = torch.float32, *,
                   generator: Optional[torch.Generator] = None
                   ) -> ResNetTrunk:
    """1024-d features (reference: resnet50_baseline, resnet_custom.py:138)
    with torchvision's initialisation drawn from ``generator``."""
    m = ResNetTrunk(Bottleneck, (3, 4, 6), dtype)
    return init_resnet_(m, generator) if generator is not None else m


def resnet18(dtype: torch.dtype = torch.float32, *,
             generator: Optional[torch.Generator] = None) -> ResNetTrunk:
    """512-d features: the whole ResNet-18 trunk, fc stripped (reference:
    resnet18_baseline, resnet_custom.py:112-135)."""
    m = ResNetTrunk(BasicBlock, (2, 2, 2, 2), dtype)
    return init_resnet_(m, generator) if generator is not None else m


def load_resnet_(model: ResNetTrunk, sd) -> ResNetTrunk:
    """Load a reference or torchvision ResNet state dict (the output of
    models/convert.load_torch_state_dict with checkpoint_key=None). Keys
    the trunk does not hold (layer4 of a full ResNet-50, fc) are ignored;
    a missing trunk key raises."""
    missing, _ = model.load_state_dict(dict(sd), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    return model
