"""Serving configuration: the inference fields of the JAX ``ModelConfig``.

Same names and defaults as ``s2anet_tpu/utils/config.py::ModelConfig``
(a test holds them equal); the training, int8 and TPU-implementation fields
are left out, and so is the YAML loader.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass
class ModelConfig:
    backbone: str = "resnet50"
    num_classes: int = 15
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    # clamp AlignConv sampling offsets to +-N feature cells (0 = off, exact
    # reference semantics)
    align_offset_clamp: float = 0.0
    # fold each BatchNorm into its conv at load time (models/fold.py)
    fold_bn: bool = True
    # inference: decode + NMS (the eval protocol's threshold)
    score_thr: float = 0.05
    # predict's saving threshold, kept apart from the eval protocol's
    predict_score_thr: float = 0.3
    nms_iou_thr: float = 0.5
    max_before_nms_per_level: int = 2000
    max_per_img: int = 2000
    pre_nms_cap: int = 4096


DOTA10_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
)
