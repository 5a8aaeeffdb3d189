"""3-D ResNets, ResNeXts and wide ResNets for classification.

Counterpart of ``torch_em_tpu/models/resnet3d.py`` (``ResNet3dModule`` and
its ten factories): a 7^3 stride-2 stem (stride 1 without ``stride_conv1``)
with batch norm and ReLU, a 3^3 stride-2 max pool, four stages of basic or
bottleneck blocks (64, 128, 256, 512 planes; ``groups`` and
``width_per_group`` widen the bottleneck's 3^3 conv), a global average pool
and a float32 linear head: (N, C, D, H, W) -> logits (N, out_channels),
float32.

The batch norms are the port's flax-semantics ``BatchNorm`` (momentum 0.9 in
flax's sense, the biased variance in the running statistics). Parameters
are float32 and named as torchvision names a ResNet's (``conv1``, ``bn1``,
``layer<s>.<b>.{conv1, bn1, conv2, bn2, conv3, bn3, downsample.0,
downsample.1}``, ``fc``); the convs compute in the model's ``dtype``
(bfloat16 under a trainer's ``mixed_precision``). The factories initialise
the weights from ``seed`` as flax initialises the JAX package's (lecun-normal
kernels, zero biases, unit norms) and record their arguments in
``model.init_kwargs`` and their path in ``model.factory``.
"""

from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import resolve_device
from .unet import BatchNorm
from .vit import at_least_f32, lecun_normal_

__all__ = [
    "ResNet3dModule", "resnet3d_18", "resnet3d_34", "resnet3d_50", "resnet3d_101", "resnet3d_152",
    "resnext3d_50_32x4d", "resnext3d_101_32x8d", "resnext3d_101_64x4d", "wide_resnet3d_50_2", "wide_resnet3d_101_2",
]


class _Conv3d(nn.Conv3d):
    """A bias-free ``nn.Conv3d`` with float32 parameters, computed in the input's dtype."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, groups=1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding, groups=groups,
                         bias=False)

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 1, base_width: int = 64,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _Conv3d(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _Conv3d(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.downsample = nn.Sequential(_Conv3d(inplanes, planes, 1, stride), BatchNorm(planes)) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(out + identity)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 1, base_width: int = 64,
                 downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = _Conv3d(inplanes, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = _Conv3d(width, width, 3, stride, 1, groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = _Conv3d(width, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = nn.Sequential(_Conv3d(inplanes, out, 1, stride), BatchNorm(out)) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        return torch.relu(self.bn3(self.conv3(h)) + identity)


class ResNet3dModule(nn.Module):
    """3-D ResNet on (N, C, D, H, W); ``block`` is ``"basic"`` or ``"bottleneck"``."""

    def __init__(self, block: str, layers: Sequence[int], in_channels: int, out_channels: int, groups: int = 1,
                 width_per_group: int = 64, stride_conv1: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        block_cls = _BasicBlock if block == "basic" else _Bottleneck
        self.in_channels, self.out_channels, self.dtype = in_channels, out_channels, dtype
        self.conv1 = _Conv3d(in_channels, 64, 7, 2 if stride_conv1 else 1, 3)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stage_blocks = []
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                down = b == 0 and (stride != 1 or inplanes != planes * block_cls.expansion)
                stage_blocks.append(block_cls(inplanes, planes, stride, groups, width_per_group, down))
                inplanes = planes * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*stage_blocks))
        self.fc = nn.Linear(inplanes, out_channels)

    def reset_parameters_from(self, generator: torch.Generator):
        """flax's initialisers, as the JAX package's module: lecun-normal kernels (the
        grouped convs' fan-in is per group), zero bias, unit norms with zero running means and
        unit running variances."""
        for m in self.modules():
            if isinstance(m, (_Conv3d, nn.Linear)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x.to(self.dtype))))
        h = F.max_pool3d(h, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = stage(h)
        return F.linear(at_least_f32(h).mean(dim=(2, 3, 4)), self.fc.weight, self.fc.bias)


def _resnet(factory, block: str, layers, in_channels: int, out_channels: int, kwargs, groups: int = 1,
            width_per_group: int = 64) -> ResNet3dModule:
    """Build, seed and place the model of ``factory`` from its caller's ``kwargs`` (``seed``,
    ``dtype``, ``device``, ``stride_conv1`` and the plain ResNets' ``groups`` and
    ``width_per_group``), which ``init_kwargs`` records."""
    init_kwargs = dict(in_channels=in_channels, out_channels=out_channels, **kwargs)
    kwargs = dict(kwargs)
    seed, device = kwargs.pop("seed", 0), kwargs.pop("device", "cuda")
    groups, width_per_group = kwargs.pop("groups", groups), kwargs.pop("width_per_group", width_per_group)
    model = ResNet3dModule(block, layers, in_channels, out_channels, groups=groups, width_per_group=width_per_group,
                           stride_conv1=kwargs.pop("stride_conv1", True), dtype=kwargs.pop("dtype", torch.float32))
    if kwargs:
        raise TypeError(f"{factory.__name__}: unexpected arguments {sorted(kwargs)}")
    with torch.no_grad():
        model.reset_parameters_from(torch.Generator().manual_seed(seed))
    model.factory = f"{factory.__module__}.{factory.__qualname__}"
    model.init_kwargs = {**init_kwargs, "device": str(device)}
    return model.to(resolve_device(device)).eval()


def resnet3d_18(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNet3d-18."""
    return _resnet(resnet3d_18, "basic", [2, 2, 2, 2], in_channels, out_channels, kwargs)


def resnet3d_34(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNet3d-34."""
    return _resnet(resnet3d_34, "basic", [3, 4, 6, 3], in_channels, out_channels, kwargs)


def resnet3d_50(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNet3d-50."""
    return _resnet(resnet3d_50, "bottleneck", [3, 4, 6, 3], in_channels, out_channels, kwargs)


def resnet3d_101(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNet3d-101."""
    return _resnet(resnet3d_101, "bottleneck", [3, 4, 23, 3], in_channels, out_channels, kwargs)


def resnet3d_152(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNet3d-152."""
    return _resnet(resnet3d_152, "bottleneck", [3, 8, 36, 3], in_channels, out_channels, kwargs)


def resnext3d_50_32x4d(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNeXt3d-50 32x4d."""
    return _resnet(resnext3d_50_32x4d, "bottleneck", [3, 4, 6, 3], in_channels, out_channels, kwargs, groups=32,
                   width_per_group=4)


def resnext3d_101_32x8d(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNeXt3d-101 32x8d."""
    return _resnet(resnext3d_101_32x8d, "bottleneck", [3, 4, 23, 3], in_channels, out_channels, kwargs, groups=32,
                   width_per_group=8)


def resnext3d_101_64x4d(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """ResNeXt3d-101 64x4d."""
    return _resnet(resnext3d_101_64x4d, "bottleneck", [3, 4, 23, 3], in_channels, out_channels, kwargs, groups=64,
                   width_per_group=4)


def wide_resnet3d_50_2(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """WideResNet3d-50-2."""
    return _resnet(wide_resnet3d_50_2, "bottleneck", [3, 4, 6, 3], in_channels, out_channels, kwargs,
                   width_per_group=64 * 2)


def wide_resnet3d_101_2(in_channels: int, out_channels: int, **kwargs: Any) -> ResNet3dModule:
    """WideResNet3d-101-2."""
    return _resnet(wide_resnet3d_101_2, "bottleneck", [3, 4, 23, 3], in_channels, out_channels, kwargs,
                   width_per_group=64 * 2)
