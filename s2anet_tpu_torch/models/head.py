"""S2ANet head (FAM -> anchor refinement -> AlignConv -> ORConv -> ODM), its
training loss and inference decoding.

Counterpart of ``s2anet_tpu/models/head.py`` (``S2ANetHead``,
``compute_s2anet_loss``, ``s2anet_get_bboxes``). The conv stacks are shared
across the FPN levels.

Numerics pinned to the JAX package:
  * the four prediction heads (``fam_reg_head``, ``fam_cls_head``,
    ``odm_reg_head``, ``odm_cls_head``) keep float32 parameters and compute
    in float32 even in a bfloat16 run -- flax promotes a bfloat16 input
    with float32 parameters to float32 there; everything else computes in
    the input's type;
  * outputs and anchors are flattened in NHWC (h, w) row-major order;
  * anchor refinement decodes the detached FAM deltas with
    ``wh_ratio_clip=1e-6``, the final boxes with the default 16/1000;
  * the AlignConv offsets are cast to the feature type before the kernel,
    whose sample coordinates are float32.

Module names follow the reference's torch key layout (``fam_reg_ls.{i}.0``,
``align_conv.deform_conv.weight``, ``or_conv.weight``/``bias``, ...).

``with_orconv=False`` (JAX ``S2ANetHead.with_orconv``): ``or_conv`` is a
plain 3x3 conv with a bias, fc -> fc, and the ODM classification stack
reads its output directly, without the rotation-invariant pooling (so it
takes fc input channels, not fc/8). The JAX head builds that conv without
a dtype, so flax computes it in float32 when a bfloat16 feature meets its
float32 parameters, and the ODM stacks then compute in float32 too; here
the same: ``or_conv`` computes in its weight's type and
:meth:`S2ANetHead.float32_modules` names the three modules a bfloat16
cast leaves in float32.

int8 serving (``ops/quant.py``, switched by ``S2ANet.set_quant``): the
stacks (``head_stacks``), the prediction heads (``heads``) and the ORConv
(``orconv``, its ARF-expanded kernel quantised per output channel) keep
one activation range per FPN level, since their weights are shared across
the levels. A quantised prediction head computes in its input's type, as
the JAX ``QuantConv`` does. The AlignConv always stays float.

On a height-sharded image (``parallel/rows.py``, spatial serving) the
convs fetch their halo rows, the anchors and AlignConv offsets are those
of the rank's rows of the whole image (absolute rows), and the AlignConv
runs on a halo-extended or gathered block (``rows.deform_rows``, the
counterpart of the JAX ``_spatial_hat``).
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
from ..ops.quant import QuantMixin, call_conv
from ..ops.rbox import rboxes_decode, rboxes_encode
from ..ops.topk import top_k
from ..parallel import mesh, rows
from ..utils.profiler import span
from .anchors import grid_anchors_on
from .assigner import assign_labels
from .conv import Conv2d
from .losses import focal_loss_with_logits, smooth_l1_loss


_STACKED_CONVS = 2  # convs per FAM/ODM stack
_N_ORIENT = 8       # ORConv rotations, pooled by rotation_invariant_pooling


def _bias_init_with_prob(prob: float) -> float:
    return -math.log((1 - prob) / prob)


class ConvStack(nn.Sequential):
    """n x (3x3 conv + ReLU); the first conv takes ``cin`` channels. The
    range slot reaches quantised convs."""

    def __init__(self, cin: int, feat: int, n: int):
        super().__init__(*(
            nn.Sequential(Conv2d(cin if i == 0 else feat, feat, 3, 1, 1), nn.ReLU())
            for i in range(n)))

    def forward(self, x: torch.Tensor, slot: int = 0) -> torch.Tensor:
        for conv, act in self:
            x = act(call_conv(conv, x, slot))
        return x


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
        offsets = align_conv_offsets(anchors, (h, w), float(stride),
                                     row0=rows.first_row(h))
        if self.offset_clamp > 0:
            offsets = offsets.clamp(-self.offset_clamp, self.offset_clamp)
        return torch.relu(rows.deform_rows(self.deform_conv, x_nhwc, offsets,
                                           self.offset_clamp))


class ORConv2d(nn.Module, QuantMixin):
    """ARF conv with one input orientation and ``n_rot`` rotated copies:
    ``weight [Cout/n_rot, Cin, 1, 3, 3]`` expands to ``[Cout, Cin, 3, 3]``.
    Quantisable (``ops/quant.py::QuantMixin``) with one range per level."""

    stride = padding = (1, 1)

    def __init__(self, cin: int, cout: int, n_rot: int = 8, range_slots: int = 5):
        super().__init__()
        self.n_rot = n_rot
        self.weight = nn.Parameter(torch.empty(cout // n_rot, cin, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self._init_quant(range_slots)

    def quant_kernel(self) -> torch.Tensor:
        return rotate_arf(self.weight, self.n_rot).permute(2, 3, 1, 0)  # HWIO

    def float_forward(self, x: torch.Tensor) -> torch.Tensor:
        w = rotate_arf(self.weight, self.n_rot).to(x.dtype)
        y = rows.conv2d(x, w, None, 1, 1)
        return y + self.bias.to(x.dtype)[None, :, None, None]

    def forward(self, x: torch.Tensor, slot: int = 0) -> torch.Tensor:
        return self.quant_forward(x, slot)


class S2ANetHead(nn.Module):
    """Two-conv FAM and ODM stacks, one anchor per cell (scale 4, ratio 1,
    angle 0) and an 8-orientation ORConv, as the JAX head's defaults."""

    def __init__(self, num_classes: int = 15, feat_channels: int = 256,
                 featmap_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 align_offset_clamp: float = 0.0, with_orconv: bool = True):
        super().__init__()
        fc, nc = feat_channels, num_classes
        self.featmap_strides = tuple(featmap_strides)
        self.with_orconv = with_orconv
        # the input pyramid has feat_channels channels (AlignConv is fc->fc)
        nlv = len(self.featmap_strides)
        self.fam_reg_ls = ConvStack(fc, fc, _STACKED_CONVS)
        self.fam_cls_ls = ConvStack(fc, fc, _STACKED_CONVS)
        # FAM output heads are 1x1, ODM heads 3x3
        self.fam_reg_head = Conv2d(fc, 5, 1)
        self.fam_cls_head = Conv2d(fc, nc, 1)
        self.align_conv = AlignConv(fc, align_offset_clamp)
        if with_orconv:
            self.or_conv = ORConv2d(fc, fc, _N_ORIENT, range_slots=nlv)
        else:
            self.or_conv = Conv2d(fc, fc, 3, 1, 1)
        self.odm_reg_ls = ConvStack(fc, fc, _STACKED_CONVS)
        self.odm_cls_ls = ConvStack(fc // _N_ORIENT if with_orconv else fc, fc,
                                    _STACKED_CONVS)
        self.odm_reg_head = Conv2d(fc, 5, 3, 1, 1)
        self.odm_cls_head = Conv2d(fc, nc, 3, 1, 1)
        self._anchors: dict = {}

    def prediction_heads(self):
        return (self.fam_reg_head, self.fam_cls_head, self.odm_reg_head,
                self.odm_cls_head)

    def float32_modules(self):
        """The modules that keep float32 parameters in a bfloat16 model: the
        prediction heads, and without the ORConv the plain ``or_conv`` and
        the ODM stacks it feeds (see the module docstring)."""
        extra = () if self.with_orconv else (self.or_conv, self.odm_reg_ls, self.odm_cls_ls)
        return self.prediction_heads() + extra

    def stack_sites(self):
        """``(parent, key)`` of the stacks' convs (``head_stacks``)."""
        for stack in (self.fam_reg_ls, self.fam_cls_ls, self.odm_reg_ls, self.odm_cls_ls):
            for layer in stack:
                yield layer, "0"

    def head_sites(self):
        """``(parent, key)`` of the four prediction heads (``heads``)."""
        for key in ("fam_reg_head", "fam_cls_head", "odm_reg_head", "odm_cls_head"):
            yield self, key

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

    def level_anchors(self, h: int, w: int, stride: int, device,
                      row0: int = 0) -> torch.Tensor:
        """``[H*W*A, 5]`` float32 anchor grid of one level from row
        ``row0`` (of a height-sharded image), made on ``device``
        (:func:`.anchors.grid_anchors_on`) and cached. A trace
        (``torch.export``) reads a cached grid as a constant of its graph
        but stores none: what it makes are its own fake tensors
        (:func:`..export.export_serving` fills the cache first)."""
        key = (h, w, stride, str(device), row0)
        anchors = self._anchors.get(key)
        if anchors is None:
            anchors = grid_anchors_on(device, (h, w), stride, row0)
            if not torch.compiler.is_compiling():
                self._anchors[key] = anchors
        return anchors

    @staticmethod
    def _head(conv: nn.Conv2d, x: torch.Tensor, lvl: int) -> torch.Tensor:
        if getattr(conv, "mode", "none") != "none":  # quantised: the input's type
            return _nhwc(conv(x, lvl))
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
        for lvl, (x, stride) in enumerate(zip(feats, self.featmap_strides)):
            b, _, h, w = x.shape
            fam_bbox = self._head(self.fam_reg_head, self.fam_reg_ls(x, lvl), lvl)
            fam_cls = self._head(self.fam_cls_head, self.fam_cls_ls(x, lvl), lvl)

            anchors = self.level_anchors(h, w, stride, x.device, rows.first_row(h))
            # refined anchors carry no gradient: neither the ODM loss nor the
            # AlignConv offsets train the FAM regression branch
            refine = rboxes_decode(
                anchors[None].expand(b, h * w, 5),
                fam_bbox.detach().reshape(b, h * w, 5).float(),
                wh_ratio_clip=1e-6,
            )
            align = self.align_conv(_nhwc(x), refine, stride)  # NHWC
            if self.with_orconv:
                or_feat = self.or_conv(_nchw(align), lvl)
                odm_cls_feat = _nchw(rotation_invariant_pooling(
                    _nhwc(or_feat), _N_ORIENT))
            else:
                or_feat = self.or_conv(_nchw(align).to(self.or_conv.weight.dtype))
                odm_cls_feat = or_feat

            odm_cls = self._head(self.odm_cls_head,
                                 self.odm_cls_ls(odm_cls_feat, lvl), lvl)
            odm_bbox = self._head(self.odm_reg_head, self.odm_reg_ls(or_feat, lvl), lvl)

            out["fam_cls"].append(fam_cls)
            out["fam_bbox"].append(fam_bbox)
            out["odm_cls"].append(odm_cls)
            out["odm_bbox"].append(odm_bbox)
            out["init_anchors"].append(anchors)
            out["refine_anchors"].append(refine)
        return out


def _level_loss(bbox_pred, cls_pred, anchors, assign, gt_boxes, gt_classes,
                num_classes, fl_gamma, fl_alpha, smooth_beta):
    """Masked loss sums of one level: ``(cls_loss_sum, reg_loss_sum)``.

    ``bbox_pred [B, A, 5]``, ``cls_pred [B, A, nc]``, ``anchors [B, A, 5]``,
    ``assign [B, A]`` codes, ``gt_boxes [B, G, 5]``, ``gt_classes [B, G]``.
    """
    pos = assign >= 0
    neg = assign == -1
    gt_idx = assign.clamp_min(0).long()
    matched_boxes = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 5))
    matched_cls = torch.gather(gt_classes.long(), 1, gt_idx)

    anchors = anchors.float()
    # a non-positive slot encodes against the anchor itself: zero targets,
    # no log(0) from a padded gt row
    matched_boxes = torch.where(pos[..., None], matched_boxes, anchors)
    reg_targets = rboxes_encode(anchors, matched_boxes)
    reg_loss = smooth_l1_loss(bbox_pred.float(), reg_targets, smooth_beta)
    reg_loss = (reg_loss * pos).sum()

    cls_targets = F.one_hot(matched_cls, num_classes).float() * pos[..., None]
    cls_w = (pos | neg).float()
    cls_loss = focal_loss_with_logits(cls_pred.float(), cls_targets,
                                      fl_gamma, fl_alpha)
    cls_loss = (cls_loss * cls_w[..., None]).sum()
    return cls_loss, reg_loss


def compute_s2anet_loss(outputs, gt_boxes, gt_classes, gt_mask,
                        imgs_size=(1024, 1024), num_classes: int = 15,
                        fl_gamma: float = 2.0, fl_alpha: float = 0.5,
                        smooth_beta: float = 1.0 / 9.0, odm_balance: float = 1.0,
                        reg_balance: float = 1.0,
                        fpn_balance=(1.0, 1.0, 1.0, 1.0, 1.0), distributed: bool = False):
    """Total S2ANet loss over a batch, in float32.

    FAM outputs are assigned against the initial anchors, ODM outputs against
    the (detached) refined anchors. Each sum runs over every level and the
    whole batch and is divided by the batch's positives, at least B.

    ``distributed`` (a data-parallel train step, ``parallel/mesh.py``): the
    batch is this rank's slice of the global batch, and the divisor is the
    global batch's positives, at least the global B (JAX: the loss of the
    global batch), from the two counts all-reduced on the device. The
    items are then this rank's share of the global loss; their sum over
    the ranks is the global loss (``parallel/step.py`` adds them up).

    Args:
      outputs: the head's output dict.
      gt_boxes ``[B, G, 5]``, gt_classes ``[B, G]``, gt_mask ``[B, G]``:
        padded gts, real rows first. The JAX step assigns against the first
        64 columns when no image has more real gts; the port's caller makes
        that choice on the host (:func:`..train.step.to_device`).

    Returns:
      ``(total, items[4])``, items (fam_cls, fam_reg, odm_cls, odm_reg).
    """
    b = gt_boxes.shape[0]
    init_all = torch.cat(outputs["init_anchors"], 0)
    refine_all = torch.cat(outputs["refine_anchors"], 1).detach()
    with span("s2anet.train.assign"):
        fam_assign = assign_labels(init_all, gt_boxes, gt_mask, imgs_size)
        odm_assign = assign_labels(refine_all, gt_boxes, gt_mask, imgs_size)
    if distributed:
        counts = torch.stack([(fam_assign >= 0).sum(), (odm_assign >= 0).sum()])
        fam_total_pos, odm_total_pos = mesh.all_reduce_sum(counts).clamp_min(
            b * mesh.world_size()).float().unbind(0)
    else:
        fam_total_pos = (fam_assign >= 0).sum().clamp_min(b).float()
        odm_total_pos = (odm_assign >= 0).sum().clamp_min(b).float()

    fam_cls_loss = fam_reg_loss = odm_cls_loss = odm_reg_loss = 0.0
    start = 0
    for lvl, anchors in enumerate(outputs["init_anchors"]):
        n = anchors.shape[0]
        sl = slice(start, start + n)
        start += n
        w = fpn_balance[lvl]
        c, r = _level_loss(
            outputs["fam_bbox"][lvl].reshape(b, n, 5),
            outputs["fam_cls"][lvl].reshape(b, n, num_classes),
            anchors[None].expand(b, n, 5), fam_assign[:, sl],
            gt_boxes, gt_classes, num_classes, fl_gamma, fl_alpha, smooth_beta)
        fam_cls_loss = fam_cls_loss + w * c
        fam_reg_loss = fam_reg_loss + w * r
        c, r = _level_loss(
            outputs["odm_bbox"][lvl].reshape(b, n, 5),
            outputs["odm_cls"][lvl].reshape(b, n, num_classes),
            refine_all[:, sl], odm_assign[:, sl],
            gt_boxes, gt_classes, num_classes, fl_gamma, fl_alpha, smooth_beta)
        odm_cls_loss = odm_cls_loss + w * c
        odm_reg_loss = odm_reg_loss + w * r

    fam_cls_loss = fam_cls_loss / fam_total_pos
    fam_reg_loss = fam_reg_loss / fam_total_pos * reg_balance
    odm_cls_loss = odm_cls_loss / odm_total_pos * odm_balance
    odm_reg_loss = odm_reg_loss / odm_total_pos * odm_balance * reg_balance
    items = torch.stack([fam_cls_loss, fam_reg_loss, odm_cls_loss, odm_reg_loss])
    return items.sum(), items


def decode_levels(outputs, max_before_nms_per_level: int = 2000):
    """Sigmoid scores and decoded boxes of the ODM outputs, after a per-level
    top-k prefilter on each anchor's best class (ties: the lower index
    first, as in ``lax.top_k``).

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
            _, idx = top_k(scores.amax(-1), max_before_nms_per_level)
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
    rotated NMS, batched. Under a profiler the span ``s2anet.post``, holding
    ``s2anet.decode`` and ``s2anet.nms``.

    Returns:
      ``det_boxes [B, max_per_img, 6]``, ``det_labels [B, max_per_img]``,
      ``det_valid [B, max_per_img]``.
    """
    with span("s2anet.post"):
        with span("s2anet.decode"):
            boxes, scores = decode_levels(outputs, max_before_nms_per_level)
        with span("s2anet.nms"):
            return multiclass_nms_rotated(boxes, scores, score_thr, iou_thr,
                                          max_per_img=max_per_img,
                                          pre_nms_cap=pre_nms_cap)
