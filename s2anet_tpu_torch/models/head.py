"""S2ANet head (FAM -> anchor refinement -> AlignConv -> ORConv -> ODM) and
inference decoding.

Counterpart of ``s2anet_tpu/models/head.py`` (``S2ANetHead`` in inference,
``s2anet_get_bboxes``). The conv stacks are shared across the FPN levels.

Numerics pinned to the JAX package:
  * the four prediction heads (``fam_reg_head``, ``fam_cls_head``,
    ``odm_reg_head``, ``odm_cls_head``) keep float32 parameters and compute
    in float32 even in a bfloat16 run -- flax promotes a bfloat16 input
    with float32 parameters to float32 there; everything else computes in
    the input's type;
  * outputs and anchors are flattened in NHWC (h, w) row-major order;
  * anchor refinement decodes with ``wh_ratio_clip=1e-6``, the final boxes
    with the default 16/1000;
  * the AlignConv offsets are cast to the feature type before the kernel,
    whose sample coordinates are float32.

Module names follow the reference's torch key layout (``fam_reg_ls.{i}.0``,
``align_conv.deform_conv.weight``, ``or_conv.weight``/``bias``, ...).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import align_conv_offsets, deform_conv2d
from ..ops.nms_rotated import multiclass_nms_rotated
from ..ops.orn import rotate_arf, rotation_invariant_pooling
from ..ops.rbox import rboxes_decode
from .anchors import grid_anchors


_STACKED_CONVS = 2  # convs per FAM/ODM stack
_N_ORIENT = 8       # ORConv rotations, pooled by rotation_invariant_pooling


def _bias_init_with_prob(prob: float) -> float:
    return -math.log((1 - prob) / prob)


def _conv_stack(cin: int, feat: int, n: int) -> nn.Sequential:
    """n x (3x3 conv + ReLU); the first conv takes ``cin`` channels."""
    return nn.Sequential(*(
        nn.Sequential(nn.Conv2d(cin if i == 0 else feat, feat, 3, 1, 1),
                      nn.ReLU())
        for i in range(n)))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class DeformConv(nn.Module):
    """3x3 deformable conv without bias; ``weight`` is OIHW (torch layout),
    the kernel takes HWIO."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))

    def forward(self, x_nhwc: torch.Tensor, offsets: torch.Tensor):
        w = self.weight.permute(2, 3, 1, 0).to(x_nhwc.dtype)
        return deform_conv2d(x_nhwc, offsets.to(x_nhwc.dtype), w)


class AlignConv(nn.Module):
    """Deformable conv whose offsets sample each refined anchor's rotated
    3x3 grid, followed by ReLU."""

    def __init__(self, channels: int, offset_clamp: float = 0.0):
        super().__init__()
        self.deform_conv = DeformConv(channels, channels)
        self.offset_clamp = offset_clamp

    def forward(self, x_nhwc: torch.Tensor, anchors: torch.Tensor,
                stride: int) -> torch.Tensor:
        _, h, w, _ = x_nhwc.shape
        offsets = align_conv_offsets(anchors, (h, w), float(stride))
        if self.offset_clamp > 0:
            offsets = offsets.clamp(-self.offset_clamp, self.offset_clamp)
        return torch.relu(self.deform_conv(x_nhwc, offsets))


class ORConv2d(nn.Module):
    """ARF conv with one input orientation and ``n_rot`` rotated copies:
    ``weight [Cout/n_rot, Cin, 1, 3, 3]`` expands to ``[Cout, Cin, 3, 3]``."""

    def __init__(self, cin: int, cout: int, n_rot: int = 8):
        super().__init__()
        self.n_rot = n_rot
        self.weight = nn.Parameter(torch.empty(cout // n_rot, cin, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = rotate_arf(self.weight, self.n_rot).to(x.dtype)
        y = F.conv2d(x, w, padding=1)
        return y + self.bias.to(x.dtype)[None, :, None, None]


class S2ANetHead(nn.Module):
    """Two-conv FAM and ODM stacks, one anchor per cell (scale 4, ratio 1,
    angle 0) and an 8-orientation ORConv, as the JAX head's defaults."""

    def __init__(self, num_classes: int = 15, feat_channels: int = 256,
                 featmap_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 align_offset_clamp: float = 0.0):
        super().__init__()
        fc, nc = feat_channels, num_classes
        self.featmap_strides = tuple(featmap_strides)
        # the input pyramid has feat_channels channels (AlignConv is fc->fc)
        self.fam_reg_ls = _conv_stack(fc, fc, _STACKED_CONVS)
        self.fam_cls_ls = _conv_stack(fc, fc, _STACKED_CONVS)
        # FAM output heads are 1x1, ODM heads 3x3
        self.fam_reg_head = nn.Conv2d(fc, 5, 1)
        self.fam_cls_head = nn.Conv2d(fc, nc, 1)
        self.align_conv = AlignConv(fc, align_offset_clamp)
        self.or_conv = ORConv2d(fc, fc, _N_ORIENT)
        self.odm_reg_ls = _conv_stack(fc, fc, _STACKED_CONVS)
        self.odm_cls_ls = _conv_stack(fc // _N_ORIENT, fc, _STACKED_CONVS)
        self.odm_reg_head = nn.Conv2d(fc, 5, 3, 1, 1)
        self.odm_cls_head = nn.Conv2d(fc, nc, 3, 1, 1)
        self._anchors: dict = {}

    def prediction_heads(self):
        return (self.fam_reg_head, self.fam_cls_head, self.odm_reg_head,
                self.odm_cls_head)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """normal(0, 0.01) kernels; zero biases except the two class heads,
        whose bias gives a prior probability of 0.01."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, DeformConv, ORConv2d)):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)
        for m in (self.fam_cls_head, self.odm_cls_head):
            nn.init.constant_(m.bias, _bias_init_with_prob(0.01))

    def level_anchors(self, h: int, w: int, stride: int, device) -> torch.Tensor:
        """``[H*W*A, 5]`` float32 anchor grid of one level, cached."""
        key = (h, w, stride, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                grid_anchors((h, w), stride)).to(device)
        return self._anchors[key]

    @staticmethod
    def _head(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(conv(x.to(conv.weight.dtype)))

    def forward(self, feats):
        """Run the head on the FPN pyramid.

        Args:
          feats: sequence of ``[B, C, H_l, W_l]`` maps, one per stride.

        Returns:
          dict of per-level lists: ``fam_cls``/``odm_cls`` ``[B, H, W, nc]``
          and ``fam_bbox``/``odm_bbox`` ``[B, H, W, 5]`` (NHWC, float32),
          ``init_anchors [H*W, 5]`` and ``refine_anchors [B, H*W, 5]``.
        """
        out = {k: [] for k in ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox",
                               "init_anchors", "refine_anchors")}
        for x, stride in zip(feats, self.featmap_strides):
            b, _, h, w = x.shape
            fam_bbox = self._head(self.fam_reg_head, self.fam_reg_ls(x))
            fam_cls = self._head(self.fam_cls_head, self.fam_cls_ls(x))

            anchors = self.level_anchors(h, w, stride, x.device)
            refine = rboxes_decode(
                anchors[None].expand(b, h * w, 5),
                fam_bbox.reshape(b, h * w, 5).float(),
                wh_ratio_clip=1e-6,
            )
            align = self.align_conv(_nhwc(x), refine, stride)  # NHWC
            or_feat = self.or_conv(_nchw(align))
            odm_cls_feat = _nchw(rotation_invariant_pooling(
                _nhwc(or_feat), _N_ORIENT))

            odm_cls = self._head(self.odm_cls_head, self.odm_cls_ls(odm_cls_feat))
            odm_bbox = self._head(self.odm_reg_head, self.odm_reg_ls(or_feat))

            out["fam_cls"].append(fam_cls)
            out["fam_bbox"].append(fam_bbox)
            out["odm_cls"].append(odm_cls)
            out["odm_bbox"].append(odm_bbox)
            out["init_anchors"].append(anchors)
            out["refine_anchors"].append(refine)
        return out


def decode_levels(outputs, max_before_nms_per_level: int = 2000):
    """Sigmoid scores and decoded boxes of the ODM outputs, after a per-level
    top-k prefilter on each anchor's best class.

    Returns ``(boxes [B, N, 5], scores [B, N, C])``, levels concatenated.
    """
    nc = outputs["odm_cls"][0].shape[-1]
    b = outputs["odm_cls"][0].shape[0]
    scores_cat, deltas_cat, anchors_cat = [], [], []
    for cls, bbox, anc in zip(outputs["odm_cls"], outputs["odm_bbox"],
                              outputs["refine_anchors"]):
        scores = torch.sigmoid(cls.reshape(b, -1, nc).float())
        bbox = bbox.reshape(b, -1, 5).float()
        n = scores.shape[1]
        if 0 < max_before_nms_per_level < n:
            _, idx = scores.amax(-1).topk(max_before_nms_per_level, dim=1)
            scores = torch.gather(scores, 1, idx[..., None].expand(-1, -1, nc))
            bbox = torch.gather(bbox, 1, idx[..., None].expand(-1, -1, 5))
            anc = torch.gather(anc, 1, idx[..., None].expand(-1, -1, 5))
        scores_cat.append(scores)
        deltas_cat.append(bbox)
        anchors_cat.append(anc)
    boxes = rboxes_decode(torch.cat(anchors_cat, 1), torch.cat(deltas_cat, 1))
    return boxes, torch.cat(scores_cat, 1)


def s2anet_get_bboxes(outputs, score_thr: float = 0.05, iou_thr: float = 0.5,
                      max_before_nms_per_level: int = 2000,
                      max_per_img: int = 2000, pre_nms_cap: int = 4096):
    """Decode ODM predictions (:func:`decode_levels`) and run multiclass
    rotated NMS, batched.

    Returns:
      ``det_boxes [B, max_per_img, 6]``, ``det_labels [B, max_per_img]``,
      ``det_valid [B, max_per_img]``.
    """
    boxes, scores = decode_levels(outputs, max_before_nms_per_level)
    return multiclass_nms_rotated(boxes, scores, score_thr, iou_thr,
                                  max_per_img=max_per_img,
                                  pre_nms_cap=pre_nms_cap)
