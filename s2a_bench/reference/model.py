"""The plain reference of S2ANet (ResNet -> FPN -> S2ANet head), float32.

Written from the published description (Han et al., "Align Deep Features
for Oriented Object Detection", arXiv:2008.09397): a ResNet with
BatchNorm, an FPN with P6/P7 from C5, and a head of two-conv FAM stacks,
anchor refinement, the AlignConv (a 3x3 deformable conv whose offsets
sample each refined anchor's rotated grid), an 8-way Active Rotating
Filter conv, rotation-invariant pooling for classification, and two-conv
ODM stacks. Module and parameter names follow the torch key layout of
the published checkpoints, so one ``state_dict`` serves the program and
this reference. BatchNorm runs on the batch's statistics in training and
on the running statistics in eval (what folding computes at serving
time). The AlignConv samples with ``grid_sample`` (bilinear, zero padded)
and multiplies tap by tap.

``set_precision("int8")`` rounds every conv's input, weight and output,
and their gradients, to symmetric int8 at one scale a tensor (the products
stay float32), as an int8 training pipeline stores them: the control that
computes below the configuration's bfloat16. Call :func:`plain_math`
first: it turns TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .geometry import align_offsets, grid_anchors, rboxes_decode, rotate_arf

BLOCKS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet34": ("basic", (3, 4, 6, 3)),
          "resnet50": ("bottleneck", (3, 4, 6, 3)), "resnet101": ("bottleneck", (3, 4, 23, 3))}


def plain_math() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_int8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(t / scale).clamp(-127, 127) * scale


class _INT8(torch.autograd.Function):
    """int8 training's rounding: symmetric, one scale a tensor, forward and
    gradient."""

    @staticmethod
    def forward(ctx, t):
        return _round_int8(t)

    @staticmethod
    def backward(ctx, g):
        return _round_int8(g)


def fake_int8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to symmetric int8 at one scale for the tensor, as
    float32; its gradient rounded so too."""
    return _INT8.apply(t)


class Conv(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision == "int8":
            return fake_int8(F.conv2d(fake_int8(x), fake_int8(self.weight), self.bias,
                                      self.stride, self.padding))
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = Conv(cin, planes, 1, bias=False), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, stride, 1, bias=False), nn.BatchNorm2d(planes)
        self.conv3, self.bn3 = Conv(planes, out, 1, bias=False), nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(Conv(cin, out, 1, stride, bias=False), nn.BatchNorm2d(out))
                           if stride != 1 or cin != out else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + r)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, planes, 3, stride, 1, bias=False), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, 1, 1, bias=False), nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(Conv(cin, planes, 1, stride, bias=False), nn.BatchNorm2d(planes))
                           if stride != 1 or cin != planes else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + r)


class ResNet(nn.Module):
    def __init__(self, arch):
        super().__init__()
        kind, depths = BLOCKS[arch]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        stages, cin, planes = [], 64, 64
        for s, n in enumerate(depths):
            blocks = []
            for i in range(n):
                blocks.append(block(cin, planes, 1 if s == 0 or i > 0 else 2))
                cin = planes * block.expansion
            stages.append(nn.Sequential(*blocks))
            planes *= 2
        self.channels = [c * block.expansion for c in (128, 256, 512)]
        self.backbone = nn.Sequential(
            nn.Sequential(Conv(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64), nn.ReLU()),
            nn.Sequential(nn.MaxPool2d(3, 2, 1), stages[0]), *stages[1:])

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.backbone):
            x = layer(x)
            if i >= 2:
                outs.append(x)
        return outs


class FPN(nn.Module):
    def __init__(self, cins, cout=256, num_outs=5):
        super().__init__()
        self.lateral_convs = nn.ModuleList(Conv(c, cout, 1) for c in cins)
        self.fpn_convs = nn.ModuleList([Conv(cout, cout, 3, 1, 1) for _ in cins] + [
            Conv(cins[-1] if i == 0 else cout, cout, 3, 2, 1) for i in range(num_outs - len(cins))])

    def forward(self, xs):
        lat = [conv(x) for conv, x in zip(self.lateral_convs, xs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], scale_factor=2, mode="nearest")
        outs = [self.fpn_convs[i](lat[i]) for i in range(len(lat))]
        for i, conv in enumerate(self.fpn_convs[len(lat):]):
            outs.append(conv(xs[-1] if i == 0 else outs[-1]))
        return outs


def stack(cin, feat=256, n=2):
    return nn.Sequential(*(nn.Sequential(Conv(cin if i == 0 else feat, feat, 3, 1, 1), nn.ReLU())
                           for i in range(n)))


class DeformConv(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, c, 3, 3))
        self.precision = "fp32"

    def forward(self, x, offsets):
        """``x [B, C, H, W]``, offsets ``[B, H, W, 9, 2]`` (dy, dx) ->
        ``[B, Cout, H, W]``: tap ``t`` samples at (y + t//3 - 1 + dy,
        x + t%3 - 1 + dx)."""
        b, c, h, w = x.shape
        wt = self.weight
        low = self.precision == "int8"
        if low:
            x, wt = fake_int8(x), fake_int8(wt)
        gy = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
        gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
        out = 0
        for t in range(9):
            py = gy + (t // 3 - 1) + offsets[..., t, 0]
            px = gx + (t % 3 - 1) + offsets[..., t, 1]
            # pixel p at (2p + 1) / n - 1 of align_corners=False's frame
            grid = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1], -1)
            s = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
            out = out + torch.matmul(s.permute(0, 2, 3, 1), wt[:, :, t // 3, t % 3].t())
        out = out.permute(0, 3, 1, 2)
        return fake_int8(out) if low else out


class ORConv(nn.Module):
    def __init__(self, cin, cout, n_rot=8):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout // n_rot, cin, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.precision = "fp32"

    def forward(self, x):
        w = rotate_arf(self.weight)
        if self.precision == "int8":
            return fake_int8(F.conv2d(fake_int8(x), fake_int8(w), self.bias, 1, 1))
        return F.conv2d(x, w, self.bias, 1, 1)


class AlignConv(nn.Module):
    def __init__(self, c, clamp):
        super().__init__()
        self.deform_conv = DeformConv(c)
        self.clamp = clamp

    def forward(self, x, anchors, stride):
        _, _, h, w = x.shape
        off = align_offsets(anchors, h, w, float(stride))
        if self.clamp > 0:
            off = off.clamp(-self.clamp, self.clamp)
        return F.relu(self.deform_conv(x, off))


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Head(nn.Module):
    def __init__(self, nc, strides, clamp, fc=256):
        super().__init__()
        self.strides = tuple(strides)
        self.fam_reg_ls, self.fam_cls_ls = stack(fc), stack(fc)
        self.fam_reg_head, self.fam_cls_head = Conv(fc, 5, 1), Conv(fc, nc, 1)
        self.align_conv = AlignConv(fc, clamp)
        self.or_conv = ORConv(fc, fc)
        self.odm_reg_ls, self.odm_cls_ls = stack(fc), stack(fc // 8)
        self.odm_reg_head, self.odm_cls_head = Conv(fc, 5, 3, 1, 1), Conv(fc, nc, 3, 1, 1)

    def forward(self, feats, with_fam_cls: bool):
        """Per-level lists, NHWC: ``fam_cls`` (only ``with_fam_cls``),
        ``fam_bbox``, ``odm_cls``, ``odm_bbox``; ``anchors [H*W, 5]`` and
        ``refine [B, H*W, 5]`` (no gradient)."""
        out = {k: [] for k in ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox", "anchors", "refine")}
        for x, stride in zip(feats, self.strides):
            b, _, h, w = x.shape
            fam_bbox = nhwc(self.fam_reg_head(self.fam_reg_ls(x)))
            if with_fam_cls:
                out["fam_cls"].append(nhwc(self.fam_cls_head(self.fam_cls_ls(x))))
            anchors = grid_anchors(h, w, stride, x.device)
            refine = rboxes_decode(anchors[None].expand(b, h * w, 5),
                                   fam_bbox.detach().reshape(b, h * w, 5), wh_ratio_clip=1e-6)
            or_feat = self.or_conv(self.align_conv(x, refine, stride))
            pooled = or_feat.reshape(b, or_feat.shape[1] // 8, 8, h, w).amax(2)
            out["odm_cls"].append(nhwc(self.odm_cls_head(self.odm_cls_ls(pooled))))
            out["odm_bbox"].append(nhwc(self.odm_reg_head(self.odm_reg_ls(or_feat))))
            out["fam_bbox"].append(fam_bbox)
            out["anchors"].append(anchors)
            out["refine"].append(refine)
        return out


class S2ANet(nn.Module):
    def __init__(self, backbone="resnet50", num_classes=15, strides=(8, 16, 32, 64, 128),
                 align_offset_clamp=0.0):
        super().__init__()
        self.backbone = ResNet(backbone)
        self.neck = FPN(self.backbone.channels, 256, len(strides))
        self.head = Head(num_classes, strides, align_offset_clamp)

    def forward(self, imgs, with_fam_cls: bool = False):
        return self.head(self.neck(self.backbone(imgs)), with_fam_cls)

    def set_precision(self, mode: str) -> "S2ANet":
        for m in self.modules():
            if hasattr(m, "precision"):
                m.precision = mode
        return self


def from_config(model_cfg: dict) -> S2ANet:
    return S2ANet(model_cfg["backbone"], model_cfg["num_classes"], tuple(model_cfg["strides"]),
                  model_cfg["align_offset_clamp"])
