"""Training driver: the epoch loop of ``s2anet_tpu/train/trainer.py``.

:class:`Trainer` builds the model (seeded, or from given weights, with an
optional ImageNet backbone), the optimizer with its schedule, frozen stages
and accumulation (:mod:`.optim`), and the EMA; each epoch it runs the
shuffled, augmented, sharded loader (:class:`..data.dota.BatchLoader`)
through the train step, validates the EMA module (eval mode, BN unfolded,
with the four losses) on the val chips, logs one ``results.csv`` row under
the JAX trainer's keys, and writes ``weights/last`` (every epoch),
``weights/best`` (on a new best mAP50, ``>=``), ``weights/epoch{N}`` (every
``save_period`` epochs) and, at the end, ``weights/deploy`` (the EMA
weights in float32). :meth:`train` with ``resume`` continues a run from a
checkpoint at epoch ``micro_steps // steps_per_epoch``; the loader is
seeded per epoch, so the resumed epochs see the batches of an uninterrupted
run.

**Model options.** ``frozen_stages`` and ``norm_eval`` put BatchNorms in
inference mode while training (``models/resnet.py``; the optimizer leaves
out the frozen stages' parameters, :func:`.optim.freeze_stages`),
``bn_stats_images`` samples the training BatchNorms' statistics
(``models/bn.py``), ``with_orconv: false`` gives the head a plain
``or_conv`` (``models/head.py``).

**Host and device.** The loader (``data.loader``: threads, or forked
worker processes that touch no CUDA, ``data/dota.py``) stacks each batch,
as uint8 RGB, into the pinned ring of :class:`..eval.runner.BatchPipeline`; the ring's
side stream copies it to the card while the step before it runs, and the
step scales it there (:func:`.step.to_device`). The loss items stay on the
device until the epoch ends: nothing in the loop waits for the device per
step. Every kernel launch, validation's included, is on the one compute
stream (the BN sums kernels allow one launch per device at a time).

**Data parallel** (``torchrun``, a process group of N ranks:
``parallel/mesh.py``): ``train.batch_size`` is the global batch; each rank
loads its own slice of every global batch (``BatchLoader(...,
batch_size // N, shard=rank, num_shards=N)``) and the step computes the
global batch's math (``train/step.py``), so every rank holds the same
model, EMA and optimizer. Rank 0 alone (``is_main``) creates the save dir,
writes ``config.yaml``, logs, validates, and writes the checkpoints and
the deploy weights; the others wait for its fitness at a broadcast, the
epoch's barrier. The epoch's loss items are the global batch's. Resume
loads the same file on every rank.

**Plots** (``train.plots``, on by default; ``--noplots``), rank 0 only, as
the JAX trainer draws them (:mod:`..utils.plots`, PNG without matplotlib):
``labels.png`` before the first epoch, ``train_batch{0,1,2}.png`` for the
first three batches of the run's first epoch (a resumed run draws them
again), ``pr_curves.png`` when validation saves its results, and
``results.png`` at the end. A batch's images and boxes are copied before
its pinned slot goes back to the loader, and drawn once its step is
enqueued, so the device runs the step while the host draws. The plots'
host seconds are ``timing["plots"]`` (``timing["batch_plots"]`` of them
inside the epoch loop's time).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.dota import BatchLoader, DotaDataset
from ..eval.runner import BatchPipeline, evaluate_on_chips
from ..models.detector import S2ANet
from ..models.head import compute_s2anet_loss, s2anet_get_bboxes
from ..ops.rbox import poly_to_rbox_np
from ..parallel import mesh
from ..utils import plots
from ..utils.callbacks import Callbacks
from ..utils.loggers import Loggers
from ..utils.profiler import span
from .checkpoint import load_checkpoint, save_checkpoint, strip_for_deploy
from .optim import Optimizer, freeze_stages
from .pretrained import load_pretrained_backbone
from .schedule import build_lr_schedule
from .state import ModelEMA
from .step import to_device, train_step

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ITEM_KEYS = ("fam_cls_loss", "fam_reg_loss", "odm_cls_loss", "odm_reg_loss")


def fitness(metrics: dict) -> float:
    """fitness = 1.0 * mAP50."""
    return float(metrics.get("map50", 0.0))


class _NullLoggers:
    """The loggers of a rank other than 0: accepts the calls, writes
    nothing."""

    def log_metrics(self, metrics, step):
        pass

    def close(self):
        pass


class ValStep:
    """The EMA module's validation step (JAX ``make_eval_step(use_ema=True,
    with_loss=True)``): uint8 RGB batch and its gts -> detections and the
    four loss items, on the device, without waiting."""

    def __init__(self, module, cfg: Config, device: torch.device, dtype: torch.dtype):
        self.module, self.cfg, self.device, self.dtype = module, cfg, device, dtype
        mc = cfg.model
        self.post = dict(score_thr=mc.score_thr, iou_thr=mc.nms_iou_thr,
                         max_before_nms_per_level=mc.max_before_nms_per_level,
                         max_per_img=mc.max_per_img, pre_nms_cap=mc.pre_nms_cap)
        self.loss = dict(num_classes=mc.num_classes, fl_gamma=mc.fl_gamma,
                         fl_alpha=mc.fl_alpha, smooth_beta=mc.smooth_beta,
                         odm_balance=mc.odm_balance, reg_balance=mc.reg_balance,
                         fpn_balance=tuple(mc.fpn_balance))

    @torch.no_grad()
    def __call__(self, imgs, batch):
        imgs = torch.as_tensor(imgs)
        dev = to_device(batch, self.device, self.dtype, imgs=imgs)
        out = self.module(dev["imgs"])
        dets = s2anet_get_bboxes(out, **self.post)
        s = self.cfg.data.img_size
        _, items = compute_s2anet_loss(out, dev["gt_boxes"], dev["gt_classes"],
                                       dev["gt_mask"], imgs_size=(s, s), **self.loss)
        return tuple(dets) + (items,)


class Trainer:
    def __init__(self, cfg: Config, callbacks: Optional[Callbacks] = None,
                 device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device")
        self.cfg = cfg
        self.callbacks = callbacks or Callbacks()
        # rank-0-only host work: save dir, logs, validation, checkpoints
        self.rank, self.num_processes = mesh.rank(), mesh.world_size()
        self.is_main = self.rank == 0
        self.local_batch = mesh.local_batch(cfg.train.batch_size)  # raises unless it divides
        self.dtype = DTYPES[cfg.train.dtype]
        self.save_dir = Path(cfg.train.save_dir)
        if self.is_main:
            (self.save_dir / "weights").mkdir(parents=True, exist_ok=True)
            cfg.save(self.save_dir / "config.yaml")
            self.loggers = Loggers(self.save_dir, use_wandb=bool(cfg.train.wandb_project),
                                   wandb_project=cfg.train.wandb_project,
                                   wandb_entity=cfg.train.wandb_entity,
                                   run_config=cfg.to_dict())
        else:
            self.loggers = _NullLoggers()
        self.model = S2ANet.from_config(cfg.model)
        # seconds of the last train(): the host waiting for the loader, the
        # epochs' loops to the device's end (validation apart), the plots
        self.timing = self._new_timing()

    @staticmethod
    def _new_timing() -> dict:
        return {"loader_wait": 0.0, "loop": 0.0, "steps": 0, "plots": 0.0,
                "batch_plots": 0.0}

    @property
    def plots(self) -> bool:
        """This rank draws the training plots."""
        return bool(self.cfg.train.plots) and self.is_main

    @property
    def accumulate(self) -> int:
        """Micro-steps per optimizer update."""
        nbs = self.cfg.train.nominal_batch_size
        if not nbs:
            return 1
        return max(round(nbs / self.cfg.train.batch_size), 1)

    def build(self, steps_per_epoch: int, weights: Optional[dict] = None) -> None:
        """Model weights (``weights``, a port ``state_dict``, else seeded
        from ``train.seed``; then the ``train.pretrained`` backbone), frozen
        stages, schedule, optimizer and EMA, as ``Trainer.build_state``."""
        cfg, tc = self.cfg, self.cfg.train
        if weights is not None:
            self.model.load_state_dict(weights)
        else:
            self.model.init_weights(torch.Generator().manual_seed(tc.seed))
        if tc.pretrained:
            load_pretrained_backbone(self.model, tc.pretrained, cfg.model.backbone)
        self.model = self.model.to(self.device).channels_last().train()
        freeze_stages(self.model, cfg.model.frozen_stages)
        acc = self.accumulate
        # with accumulation the schedule counts optimizer updates
        self.lr_fn = build_lr_schedule(
            tc.lr0, tc.epochs * steps_per_epoch // acc, max(steps_per_epoch // acc, 1),
            tc.lr_schedule, tuple(tc.lr_decay_epochs), tc.lr_decay_factor, tc.lrf,
            max(tc.warmup_iters // acc, 1), tc.warmup_init_factor)
        self.optimizer = Optimizer(self.model, self.lr_fn, tc.momentum, tc.weight_decay,
                                   tc.grad_clip_norm, accumulate=acc)
        self.ema = ModelEMA(self.model, tc.ema_decay, tc.ema_ramp_updates)
        self.best_fitness = 0.0

    def _train_loader(self) -> BatchLoader:
        d = self.cfg.data
        ds = DotaDataset(d.train_list or d.root, img_size=d.img_size, max_gt=d.max_gt,
                         cache_images=d.cache, augment=True, fliplr=d.fliplr,
                         flipud=d.flipud, rot90=d.degrees > 0,
                         hsv=(d.hsv_h, d.hsv_s, d.hsv_v), mixup=d.mixup, mosaic=d.mosaic,
                         translate=d.translate, scale=d.scale)
        return BatchLoader(ds, self.local_batch, num_workers=d.workers or None,
                           shuffle=True, seed=self.cfg.train.seed, drop_last=True,
                           mode=d.loader, shard=self.rank, num_shards=self.num_processes)

    def train(self, resume: Optional[str] = None, weights: Optional[dict] = None):
        cfg = self.cfg
        loader = self._train_loader()
        steps_per_epoch = max(len(loader), 1)
        self.build(steps_per_epoch, weights)
        start_epoch = 0
        if resume:
            meta = load_checkpoint(resume, self.model, self.ema, self.optimizer)
            self.best_fitness = meta["best_fitness"]
            start_epoch = self.optimizer.micro // steps_per_epoch
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # fixed shapes: autotune the convs
        self.timing = self._new_timing()

        if self.plots:
            self._timed_plot(self._plot_label_stats, loader.ds)
        self.callbacks.run("on_train_start")
        for epoch in range(start_epoch, cfg.train.epochs):
            self.callbacks.run("on_train_epoch_start")
            loader.set_epoch(epoch)
            t0 = time.time()
            items = self._epoch(loader, plot_batches=self.plots and epoch == start_epoch)
            mean_items = (np.asarray(torch.stack(items).cpu(), np.float64).mean(0)
                          if items else np.zeros(4))
            dt = time.time() - t0
            self.timing["loop"] += dt
            metrics = {f"train/{k}": float(v) for k, v in zip(ITEM_KEYS, mean_items)}
            metrics["lr/0"] = float(self.lr_fn(self.optimizer.micro // self.accumulate))
            metrics["time/epoch_s"] = dt
            fit = 0.0
            if cfg.train.val_every_epoch and cfg.data.val_list:
                if self.is_main:  # rank-0 validation
                    val_metrics = self.validate(save_results=epoch == cfg.train.epochs - 1)
                    metrics.update(val_metrics)
                    fit = fitness(val_metrics)
                if self.num_processes > 1:
                    # the same best fitness on every rank; the others wait
                    # here while rank 0 validates
                    fit = mesh.broadcast_one_to_all(fit, self.device)
            self.loggers.log_metrics(metrics, epoch)
            self.callbacks.run("on_fit_epoch_end")

            new_best = fit >= self.best_fitness
            if new_best:
                self.best_fitness = fit
            weights_dir = self.save_dir / "weights"
            names = ["last"] + (["best"] if new_best else []) + (
                [f"epoch{epoch}"] if cfg.train.save_period > 0
                and epoch % cfg.train.save_period == 0 else [])
            for name in names if self.is_main else ():
                save_checkpoint(weights_dir / name, self.model, self.ema, self.optimizer,
                                self.best_fitness, epoch, {"epoch": epoch, "fitness": fit})
            self.callbacks.run("on_model_save")

        if self.is_main:
            strip_for_deploy(self.ema, self.save_dir / "weights" / "deploy")
        self.callbacks.run("on_train_end")
        self.loggers.close()
        if self.plots:
            self._timed_plot(plots.plot_results_csv, self.save_dir / "results.csv",
                             self.save_dir / "results.png")
        return self

    def _timed_plot(self, fn, *args) -> float:
        """``fn(*args)``, its host seconds added to ``timing["plots"]``."""
        t0 = time.perf_counter()
        fn(*args)
        dt = time.perf_counter() - t0
        self.timing["plots"] += dt
        return dt

    def _plot_label_stats(self, train_ds: DotaDataset) -> None:
        """``labels.png``: the train set's boxes (in the ``img_size``
        frame) and classes; none drawn without labels."""
        s = float(self.cfg.data.img_size)
        labels = [lab for lab in train_ds.labels if len(lab)]
        if not labels:
            return
        plots.plot_label_stats(np.concatenate([poly_to_rbox_np(lab[:, 1:] * s)
                                               for lab in labels]),
                               np.concatenate([lab[:, 0] for lab in labels]),
                               self.save_dir / "labels.png",
                               num_classes=self.cfg.model.num_classes)

    def _plot_train_batch(self, imgs: np.ndarray, batch: dict, i: int) -> None:
        """``train_batch{i}.png``: the batch's images (a copy) with its gt
        boxes."""
        targets = [(batch["gt_boxes"][k][batch["gt_mask"][k]],
                    batch["gt_classes"][k][batch["gt_mask"][k]]) for k in range(len(imgs))]
        plots.plot_images_grid(imgs, targets, self.save_dir / f"train_batch{i}.png",
                               names=list(self.cfg.data.names))

    def _epoch(self, loader: BatchLoader, plot_batches: bool = False) -> list:
        """One pass over the loader; the loss items ``[4]`` of each step,
        on the device. With ``plot_batches`` the first three batches are
        drawn, each after its step is enqueued."""
        cfg = self.cfg
        items = []
        with BatchPipeline(None, self.local_batch, cfg.data.img_size,
                           device=self.device) as pipe:
            loader.staging = pipe
            batches = iter(loader)
            while True:
                with span("s2anet.train.wait_loader", self.timing, "loader_wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                i = len(items)
                self.callbacks.run("on_train_batch_start")
                # the slot goes back to the loader at stage(i): copy first
                drawn = batch["imgs"].copy() if plot_batches and i < 3 else None
                dev = to_device(batch, self.device, self.dtype, imgs=pipe.stage(i))
                items.append(train_step(self.model, self.optimizer, self.ema, dev,
                                        cfg.model))
                self.callbacks.run("on_train_batch_end")
                if drawn is not None:
                    self.timing["batch_plots"] += self._timed_plot(
                        self._plot_train_batch, drawn, batch, i)
            loader.staging = None
        self.timing["steps"] += len(items)
        return items

    def validate(self, save_results: bool = False) -> dict:
        """Chip-level validation of the EMA module: detections, VOC mAP50
        against the chips' labels, and the four val losses. The val
        dataset and step are built once."""
        cfg = self.cfg
        self.callbacks.run("on_val_start")
        if not hasattr(self, "_val_dataset"):
            self._val_dataset = DotaDataset(cfg.data.val_list or cfg.data.root,
                                            img_size=cfg.data.img_size,
                                            max_gt=cfg.data.max_gt,
                                            cache_images=cfg.data.cache)
        step = ValStep(self.ema.module, cfg, self.device, self.dtype)
        out = evaluate_on_chips(
            step, cfg, dataset=self._val_dataset, with_loss=True,
            save_dir=self.save_dir if (save_results or cfg.eval.save_results) else None)
        if (save_results or cfg.eval.save_results) and self.plots:
            self._timed_plot(plots.plot_pr_curves, out["per_class"],
                             self.save_dir / "pr_curves.png")
        self.callbacks.run("on_val_end")
        self.val_seconds = out["seconds"]["loop"]
        metrics = {"metrics/mAP_0.5": out["map50"], "metrics/precision": out["mp"],
                   "metrics/recall": out["mr"], "map50": out["map50"]}
        for k in ITEM_KEYS:
            if f"val/{k}" in out:
                metrics[f"val/{k}"] = out[f"val/{k}"]
        return metrics

