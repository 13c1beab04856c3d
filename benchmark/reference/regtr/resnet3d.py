"""3D ResNet backbone and top-down 3D feature pyramid (port of
dregnerf_tpu/models/resnet3d.py), in NCDHW.

ResNet-18/34/50/101/152 with a 5^3 stride-2 stem and a 3^3 stride-2 max
pool, four stages (the first block of a stage strides 2 after the first
stage, and takes a 1^3 projection where the stride or the width change),
GroupNorm(min(32, C), eps 1e-6) in place of BatchNorm. The pyramid is v1
(1^3 laterals at c2..c5) for bottleneck nets and v3 (3^3 laterals at c2,
c3) for basic-block nets; it returns the finest (1/2-resolution) scale.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.regtr.layers import Conv3d, GroupNorm


class BasicBlock3D(nn.Module):
    """convs/norms: 3^3 (strided), 3^3, then the 1^3 projection if any
    (flax's Conv_0..Conv_2, GroupNorm_0..GroupNorm_2)."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        convs = [Conv3d(in_channels, planes, 3, stride, 1, bias=False, compute_dtype=dt),
                 Conv3d(planes, planes, 3, 1, 1, bias=False, compute_dtype=dt)]
        self.projection = stride != 1 or in_channels != planes
        if self.projection:
            convs.append(Conv3d(in_channels, planes, 1, stride, 0, bias=False, compute_dtype=dt))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(GroupNorm(planes, dt) for _ in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.norms[0](self.convs[0](x)))
        out = self.norms[1](self.convs[1](out))
        residual = self.norms[2](self.convs[2](x)) if self.projection else x
        return F.relu(out + residual)


class Bottleneck3D(nn.Module):
    """convs/norms: 1^3, 3^3 (strided), 1^3 to 4 planes, then the 1^3
    projection if any (flax's Conv_0..Conv_3, GroupNorm_0..GroupNorm_3)."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        out_ch = planes * self.expansion
        convs = [Conv3d(in_channels, planes, 1, bias=False, compute_dtype=dt),
                 Conv3d(planes, planes, 3, stride, 1, bias=False, compute_dtype=dt),
                 Conv3d(planes, out_ch, 1, bias=False, compute_dtype=dt)]
        widths = [planes, planes, out_ch]
        self.projection = stride != 1 or in_channels != out_ch
        if self.projection:
            convs.append(Conv3d(in_channels, out_ch, 1, stride, 0, bias=False, compute_dtype=dt))
            widths.append(out_ch)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(GroupNorm(w, dt) for w in widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.norms[0](self.convs[0](x)))
        out = F.relu(self.norms[1](self.convs[1](out)))
        out = self.norms[2](self.convs[2](out))
        residual = self.norms[3](self.convs[3](x)) if self.projection else x
        return F.relu(out + residual)


ARCHS = {
    "resnet18": (BasicBlock3D, (2, 2, 2, 2)),
    "resnet34": (BasicBlock3D, (3, 4, 6, 3)),
    "resnet50": (Bottleneck3D, (3, 4, 6, 3)),
    "resnet101": (Bottleneck3D, (3, 4, 23, 3)),
    "resnet152": (Bottleneck3D, (3, 8, 36, 3)),
}


class ResNet3D(nn.Module):
    """Returns the 5 feature scales c1 (1/2) .. c5 (1/32)."""

    def __init__(self, arch: str = "resnet50", in_channels: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        block, self.layer_sizes = ARCHS[arch]
        self.stem = Conv3d(in_channels, 64, 5, 2, 2, bias=False, compute_dtype=compute_dtype)
        self.stem_norm = GroupNorm(64, compute_dtype)
        blocks, cin = [], 64
        for planes, n_blocks, stride in zip((64, 128, 256, 512), self.layer_sizes, (1, 2, 2, 2)):
            for i in range(n_blocks):
                blocks.append(block(cin, planes, stride if i == 0 else 1, compute_dtype))
                cin = planes * block.expansion
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        c1 = F.relu(self.stem_norm(self.stem(x)))
        h = F.max_pool3d(c1, 3, 2, 1)
        feats = [c1]
        blocks = iter(self.blocks)
        for n_blocks in self.layer_sizes:
            for _ in range(n_blocks):
                h = next(blocks)(h)
            feats.append(h)
        return tuple(feats)


def upsample_to(x: torch.Tensor, target_shape) -> torch.Tensor:
    """Nearest 2x upsample (each voxel repeated along D, H, W), then crop."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    td, th, tw = target_shape
    return x[:, :, :td, :th, :tw]


class FeaturePyramid3D(nn.Module):
    """[B, 4, D, H, W] -> [B, out_channels, D/2, H/2, W/2] (the finest scale)."""

    def __init__(self, arch: str = "resnet50", out_channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32, in_channels: int = 4):
        super().__init__()
        block, _ = ARCHS[arch]
        v3 = block is BasicBlock3D
        e = block.expansion
        c1, c2, c3, c4, c5 = 64, 64 * e, 128 * e, 256 * e, 512 * e
        co, dt = out_channels, compute_dtype

        def conv1(cin):
            return Conv3d(cin, co, 1, compute_dtype=dt)

        def conv3(cin):
            return Conv3d(cin, co, 3, 1, 1, compute_dtype=dt)

        lateral_mid = conv3 if v3 else conv1
        self.backbone = ResNet3D(arch, in_channels, dt)
        self.lateral5, self.lateral4, self.smooth4 = conv1(c5), conv1(c4), conv3(co)
        self.lateral3, self.smooth3 = lateral_mid(c3), conv3(co)
        self.lateral2, self.smooth2 = lateral_mid(c2), conv3(co)
        self.lateral1, self.smooth1 = conv3(c1), conv3(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3, c4, c5 = self.backbone(x)
        p5 = self.lateral5(c5)
        p4 = self.lateral4(c4)
        p4 = self.smooth4(upsample_to(p5, p4.shape[2:]) + p4)
        p3 = self.lateral3(c3)
        p3 = self.smooth3(upsample_to(p4, p3.shape[2:]) + p3)
        p2 = self.lateral2(c2)
        p2 = self.smooth2(upsample_to(p3, p2.shape[2:]) + p2)
        p1 = self.lateral1(c1)
        return self.smooth1(upsample_to(p2, p1.shape[2:]) + p1)
