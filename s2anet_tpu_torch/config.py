"""Configuration: the serving and training fields of the JAX ``ModelConfig``
and a copy of its ``TrainConfig``.

Same names and defaults as ``s2anet_tpu/utils/config.py`` (a test holds them
equal); the int8 and TPU-implementation fields are left out, and so is the
YAML loader.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass
class ModelConfig:
    backbone: str = "resnet50"
    num_classes: int = 15
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    frozen_stages: int = -1          # nothing frozen
    norm_eval: bool = False
    # loss
    fl_gamma: float = 2.0
    fl_alpha: float = 0.5
    smooth_beta: float = 1.0 / 9.0
    odm_balance: float = 1.0
    reg_balance: float = 1.0
    fpn_balance: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0)
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


@dataclass
class TrainConfig:
    epochs: int = 12
    batch_size: int = 8               # global batch
    lr0: float = 0.005
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_iters: int = 500
    warmup_init_factor: float = 1.0 / 3.0
    lr_schedule: str = "step"         # step | cosine | linear
    lr_decay_epochs: Sequence[float] = (8 / 12, 11 / 12)
    lr_decay_factor: float = 0.1
    lrf: float = 0.1                  # final fraction for cosine/linear
    grad_clip_norm: float = 35.0
    ema_decay: float = 0.9999
    ema_ramp_updates: int = 2000
    dtype: str = "bfloat16"           # compute dtype
    seed: int = 0
    save_dir: str = "runs/train/exp"
    save_period: int = -1
    val_every_epoch: bool = True
    pretrained: str = ""
    # nominal global batch for gradient accumulation; 0 disables
    nominal_batch_size: int = 0
    plots: bool = True
    wandb_project: str = ""
    wandb_entity: str = ""


DOTA10_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
)
