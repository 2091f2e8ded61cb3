"""ResNet feature extractor pieces (counterpart of `diffusiondrive_tpu/models/resnet.py`).

The stem and the stages are separate modules because the backbone
interleaves sensor-fusion transformers between ResNet stages. Tensors are
NCHW logical in channels_last memory. Module names follow the Flax scopes
(conv1/bn1/conv2/bn2/downsample_conv/downsample_bn, block{i}).

`fused_mode` is the config's `fused_conv_mode`. In eval mode, unless it is
"off", the stem (where `supports_fused_stem` holds for its input, as in
JAX; otherwise the module path below) and every BasicBlock where
`supports_fused_conv3x3` holds (layer 1 at an even width, as in JAX) call
the fused ops (`ops/stem_fused.py`,
`ops/conv_fused.py`): those run their plain versions for CPU tensors,
launch the CUDA kernels for CUDA tensors, and raise for a CUDA tensor the
kernel does not take. Their operands (the HWIO weight in the compute dtype
and the exact float32 BN affine) are made once per dtype and device. Train
mode takes the module path: `F.conv2d` (cuDNN on the card), BatchNorm with
batch statistics (`layers.BatchNorm2d`), ReLU, pool; with "train" or "interpret" the two convs
of each block where `supports_fused_conv3x3` holds run `conv3x3_train` instead (the conv3x3 kernel for the
forward and the input gradient), BatchNorm, ReLU and the residual as before.
BN eps is 1e-5. A `Bottleneck` (ResNet-50) takes the module path in every
mode, as JAX's does: its 3x3 conv never runs the conv3x3 kernel, even in
layer 1 where the shape gate would pass (JAX fuses basic stages only).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusiondrive_torch.models.layers import BatchNorm2d, Conv2d
from diffusiondrive_torch.ops.conv_fused import (
    conv3x3_train, fused_conv3x3, supports_fused_conv3x3, to_hwio)
from diffusiondrive_torch.ops.stem_fused import fused_stem, supports_fused_stem

ARCH_SPECS = {
    # name: (block, stage_sizes, stage_widths, out_channels)
    "resnet18": ("basic", (2, 2, 2, 2), (64, 128, 256, 512), (64, 128, 256, 512)),
    "resnet34": ("basic", (3, 4, 6, 3), (64, 128, 256, 512), (64, 128, 256, 512)),
    "resnet50": ("bottleneck", (3, 4, 6, 3), (64, 128, 256, 512), (256, 512, 1024, 2048)),
}


def feature_channels(name: str):
    """Per-stage output channels at reductions (4, 8, 16, 32)."""
    return ARCH_SPECS[name][3]


def _channels_last(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _kernel_operands(module: nn.Module, conv_name: str, bn_name: str, dtype: torch.dtype):
    """(HWIO weight in `dtype`, float32 scale, float32 bias) of the eval-mode
    pair `module.<conv_name>`, `module.<bn_name>`, kept in `module._operands`
    and made again only when a source tensor moves, is replaced or is
    changed in place (device, storage or version counter)."""
    conv, bn = getattr(module, conv_name), getattr(module, bn_name)
    src = (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    key = (dtype,) + tuple((t.device, t.data_ptr(), t._version) for t in src)
    hit = module._operands.get(conv_name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, (to_hwio(conv.weight, dtype), *bn.eval_affine()))
        module._operands[conv_name] = hit
    return hit[1]


class ResNetStem(nn.Module):
    """conv7x7/2 + BN + ReLU + maxpool3x3/2 (overall reduction 4)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 fused_mode: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.fused_mode = fused_mode
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype)
        self._operands = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and self.fused_mode != "off" and supports_fused_stem(x):
            w, s, b = _kernel_operands(self, "conv1", "bn1", self.dtype)
            return fused_stem(_channels_last(x, self.dtype), w, s, b)
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity or 1x1 downsample residual (torchvision BasicBlock)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, fused_mode: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.fused_mode = fused_mode
        self.features, self.stride = features, stride
        self.conv1 = Conv2d(in_features, features, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(features, dtype)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(features, dtype)
        self.has_downsample = in_features != features or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_features, features, 1, stride=stride, bias=False, dtype=dtype)
            self.downsample_bn = BatchNorm2d(features, dtype)
        self._operands = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = supports_fused_conv3x3(x, self.features, self.stride)
        if not self.training and fused and self.fused_mode != "off":
            x = _channels_last(x, self.dtype)
            w1, s1, b1 = _kernel_operands(self, "conv1", "bn1", self.dtype)
            w2, s2, b2 = _kernel_operands(self, "conv2", "bn2", self.dtype)
            y = fused_conv3x3(x, w1, s1, b1, relu=True)
            return fused_conv3x3(y, w2, s2, b2, residual=x, relu=True)

        residual = x
        if self.training and fused and self.fused_mode in ("train", "interpret"):
            y = conv3x3_train(_channels_last(x, self.dtype), to_hwio(self.conv1.weight, self.dtype))
            y = F.relu(self.bn1(y))
            y = self.bn2(conv3x3_train(_channels_last(y, self.dtype),
                                       to_hwio(self.conv2.weight, self.dtype)))
            return F.relu(y + residual.to(y.dtype))
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(residual))
        return F.relu(y + residual.to(y.dtype))


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 bottleneck (torchvision), `features` wide inside and
    4 x `features` out, for the ResNet-50 variant. No kernel in any mode."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = features * 4
        self.conv1 = Conv2d(in_features, features, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(features, dtype)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(features, dtype)
        self.conv3 = Conv2d(features, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out, dtype)
        self.has_downsample = in_features != out or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_features, out, 1, stride=stride, bias=False, dtype=dtype)
            self.downsample_bn = BatchNorm2d(out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(y + residual.to(y.dtype))


class ResNetStage(nn.Module):
    """A stack of blocks block0..blockN-1 ("basic": `BasicBlock`,
    "bottleneck": `Bottleneck`); the first downsamples when `stride` > 1."""

    def __init__(self, in_features: int, features: int, num_blocks: int, stride: int = 1,
                 block: str = "basic", dtype: torch.dtype = torch.float32, fused_mode: str = "auto"):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"ResNet block {block!r} is not 'basic' or 'bottleneck'")
        self.num_blocks = num_blocks
        out = features * 4 if block == "bottleneck" else features
        for i in range(num_blocks):
            cin, s = (in_features, stride) if i == 0 else (out, 1)
            self.add_module(f"block{i}", BasicBlock(cin, features, s, dtype, fused_mode) if block == "basic"
                            else Bottleneck(cin, features, s, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x
