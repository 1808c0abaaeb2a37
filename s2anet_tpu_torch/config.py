"""Configuration: the serving and training fields of the JAX ``ModelConfig``,
a copy of its ``TrainConfig``, and the fields of its ``DataConfig`` and
``EvalConfig`` that training and evaluation read.

Same names and defaults as ``s2anet_tpu/utils/config.py`` (a test holds them
equal); the TPU-implementation fields are left out. :func:`load_config` reads the repository's YAML files
(``configs/*.yaml``) with :mod:`.yaml_lite`, since the machine with the card
has no pyyaml, merges overrides into the defaults and applies the class-name
rule (:func:`resolve_names`). The JAX-only implementation switches
(``deform_impl``, ``bn_impl`` and the like) have nothing to switch here
and are ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

from . import yaml_lite


@dataclass
class ModelConfig:
    backbone: str = "resnet50"
    num_classes: int = 15
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    frozen_stages: int = -1          # nothing frozen
    norm_eval: bool = False
    with_orconv: bool = True
    # loss
    fl_gamma: float = 2.0
    fl_alpha: float = 0.5
    smooth_beta: float = 1.0 / 9.0
    odm_balance: float = 1.0
    reg_balance: float = 1.0
    fpn_balance: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0)
    # >0: train-time BatchNorm statistics from the first k images of the
    # batch (models/bn.py; JAX SampledBatchNorm); 0 = the whole batch
    bn_stats_images: int = 0
    # clamp AlignConv sampling offsets to +-N feature cells (0 = off, exact
    # reference semantics)
    align_offset_clamp: float = 0.0
    # int8 post-training quantisation for serving (ops/quant.py): "none" |
    # "int8" (calibrate activation ranges on the first quant_calib_batches
    # evaluation batches, then run the convs of quant_scope through the
    # int8 kernels); training always runs float
    quant: str = "none"
    quant_calib_batches: int = 4
    # module groups quantised under quant "int8" (of backbone, neck,
    # head_stacks, orconv, heads); the rest runs float
    quant_scope: Sequence[str] = ("backbone", "neck", "head_stacks")
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
# DOTA-v1.5 adds container-crane; v2.0 further adds airport and helipad
DOTA15_CLASSES = DOTA10_CLASSES + ("container-crane",)
DOTA20_CLASSES = DOTA15_CLASSES + ("airport", "helipad")
HRSC_CLASSES = ("ship",)

NAMES_PRESETS = {
    "dota": DOTA10_CLASSES, "dota-v1.0": DOTA10_CLASSES,
    "dota-v1.5": DOTA15_CLASSES, "dota-v2.0": DOTA20_CLASSES,
    "hrsc": HRSC_CLASSES, "hrsc2016": HRSC_CLASSES,
}


@dataclass
class DataConfig:
    root: str = ""
    train_list: str = ""              # txt of train image paths (YOLO layout)
    val_list: str = ""
    # class names, or a preset key ("dota", "dota-v1.5", "dota-v2.0", "hrsc")
    names: Sequence[str] = DOTA10_CLASSES
    img_size: int = 1024
    max_gt: int = 512                 # padded gt capacity per image
    # image source: "" (BGR .npy sidecars, else PIL) | "packed" (data/dota.py)
    cache: str = ""
    workers: int = 0                  # loader workers (0 = auto)
    loader: str = "thread"            # "thread" | "process" (data/dota.py)
    # augmentation (the published recipe: fliplr + 90-degree rotation)
    fliplr: float = 0.5
    flipud: float = 0.0
    degrees: float = 180.0            # >0 enables random 90-degree-multiple rotation
    hsv_h: float = 0.0
    hsv_s: float = 0.0
    hsv_v: float = 0.0
    mosaic: float = 0.0
    mixup: float = 0.0
    translate: float = 0.0
    scale: float = 0.0
    val_gt_dir: str = ""              # per-image DOTA labelTxt dir (merge mode)


@dataclass
class EvalConfig:
    batch_size: int = 16
    is_map_split: bool = True         # evaluate against split-chip GT
    conf_thres: float = 0.05
    iou_thres: float = 0.5            # TP matching IoU
    merge_nms_thr: float = 0.5        # cross-chip polygon NMS
    use_07_metric: bool = True        # 11-point VOC AP
    save_results: bool = False        # dump per-class DOTA-format txt files
    task: int = 1                     # 1 = oriented (Task1), 2 = horizontal
    # rect batching: shape-ordered batches, each letterboxed to its own
    # minimal shape rounded up to rect_stride (data/dota.py::BatchLoader)
    rect: bool = False
    rect_stride: int = 32


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path) -> None:
        """Write ``config.yaml``: :func:`load_config` and ``yaml.safe_load``
        both read it back to :meth:`to_dict` (tuples as lists)."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(yaml_lite.dump(self.to_dict()))


def resolve_names(cfg: Config, names_explicit: bool) -> Config:
    """``load_config``'s class-name rule: a preset key in ``data.names``
    becomes its class list; then an explicitly chosen list sets
    ``model.num_classes``, while the default list is cut or padded with
    ``class<i>`` names to ``model.num_classes`` (mAP averages over the
    names, so the two must agree)."""
    names = cfg.data.names
    if isinstance(names, str):
        if names.lower() not in NAMES_PRESETS:
            raise ValueError(f"unknown names preset {names!r}; "
                             f"options: {sorted(NAMES_PRESETS)}")
        names = NAMES_PRESETS[names.lower()]
    names = tuple(names)
    model = cfg.model
    if len(names) != model.num_classes:
        if names_explicit:
            model = dataclasses.replace(model, num_classes=len(names))
        else:
            names = names[: model.num_classes] + tuple(
                f"class{i}" for i in range(len(names), model.num_classes))
    return dataclasses.replace(cfg, model=model,
                               data=dataclasses.replace(cfg.data, names=names))


def prune_overrides(d: dict) -> dict:
    """Drop ``None`` leaves (and then-empty sub-dicts) from an override
    tree: a CLI flag the user did not type never replaces a value from
    ``--config``."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            v = prune_overrides(v)
            if v:
                out[k] = v
        elif v is not None:
            out[k] = v
    return out


def _merge(dc, overrides: dict):
    kwargs = {}
    for f in dataclasses.fields(dc):
        if f.name in overrides:
            v = overrides[f.name]
            if dataclasses.is_dataclass(getattr(dc, f.name)):
                v = _merge(getattr(dc, f.name), v)
            kwargs[f.name] = v
    return dataclasses.replace(dc, **kwargs)


def load_config(path=None, overrides: Optional[dict] = None) -> Config:
    """Defaults, then the YAML file at ``path``, then ``overrides``; class
    names resolved as ``s2anet_tpu/utils/config.py::load_config`` does."""
    cfg = Config()
    names_explicit = False
    if path:
        loaded = yaml_lite.load(Path(path).read_text()) or {}
        names_explicit |= "names" in (loaded.get("data") or {})
        cfg = _merge(cfg, loaded)
    if overrides:
        names_explicit |= bool((overrides.get("data") or {}).get("names"))
        cfg = _merge(cfg, overrides)
    return resolve_names(cfg, names_explicit)
