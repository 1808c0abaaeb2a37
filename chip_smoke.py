#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``s2anet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero before the
last line:

  1. card      name and power limit (nvidia-smi), torch and CUDA versions
  2. build     compile the CUDA kernels from csrc/ (one nvcc per source, all
               at once), build seconds, registers and spills
  3. kernel 1  AlignConv forward vs its plain version: P3 shapes in bf16
               and in f32 (TF32 off), and 1x1 / 2x2 / odd maps with offsets
               that leave the image
  4. kernel 2  rotated IoU vs the plain version (random and degenerate
               boxes, unbatched and batched with shared and per-image
               boxes1); the NMS bitmask (the bits of valid rows the sweep
               reads) and keep masks vs the plain NMS on clustered
               candidates, with valid flags as a prefix and not, with none
               valid, and on the degenerate boxes; the top-k order on the
               card (bf16-tied scores) equal to the CPU's (lax.top_k's)
  5. serving   python -m s2anet_tpu_torch.predict on 8 synthetic 1024x1024
               chips (R-50, 15 classes, bf16, folded BN, seeded weights),
               launch counts of every kernel; outputs finite with the right
               shapes; at score_thr 0.005 the kernel path against the plain
               path on the card, >= 95% of detections matched 1:1: in bf16
               by (label, score, rotated IoU >= 0.5), in float32 (TF32 off)
               by (label, score, centre within 1 px)
  6. times     chips/s at batch 8 (2 warm-up batches, 7 timed) at score_thr
               0.05 and 0.005 (where the NMS has 4096 valid candidates per
               image), peak device memory, each kernel against its plain
               version (CUDA events), the NMS mask also on 8 x 4096
               clustered candidates with its own bound, the NMS sweep also
               with no valid candidate and the rounds its rule takes (a
               numpy model), the decode + select of a serving batch at
               score_thr 0.005 with torch.topk (before the tie fix) and the
               stable sort, in turns, with the launches of each,
               the AlignConv forward per level P3-P7 (TFLOP/s, gathered
               bytes/s, and cuDNN's bf16 3x3 convolution of the same shape
               as a yardstick, dense_conv_ms), and a profiler table of one
               batch (--out, default runs/chip_smoke/)
  7. kernel 3  AlignConv backward (dx, dW) vs autograd of the plain forward:
               P3 shapes (batch 2, 128^2, C = Cout = 256) in f32 (TF32 off)
               and bf16, odd, 1x1, P7 and off-image maps; f32 within 1e-3
               and bf16 within 2e-2 of the largest reference value; bf16 dW
               equal bit for bit over repeated runs; P3-P7 times, and per
               level the dW, dx, finishing and memset launches (profiler)
  8. kernels 5, 6, BN apply, BN dx  the training BatchNorm's kernels vs
               their plain versions at the R-50 stem, a layer-4, an odd
               (C 24) and a 1x1 shape, f32 and bf16: the moment and pair
               sums within 1e-5 of the sums of magnitudes; their finishing
               outputs (mean, var, rstd, mul, running statistics, dgamma,
               dbeta, dx coefficients) within 1e-6 of the plain finishing
               on the same sums; apply and dx equal to their plain versions
               bit for bit on the same per-channel vectors. Times over the
               53 BatchNorm inputs of one R-50 1024^2 batch-8 step, each
               kernel in turns with its library call
               (torch.batch_norm_stats, torch.batch_norm_backward_reduce,
               torch.batch_norm_elemt, torch.batch_norm_backward_elemt);
               the sums kernels' device time per kernel name (profiler)
               beside their event-timed sweep and the host's enqueue time
               per call; and the whole BN forward and backward against cuDNN's
               F.batch_norm: per input, and as a step runs the layers (53
               forwards, then one backward over all of them) with the
               kernel time and the host's enqueue time of the latter
  9. training  python -m s2anet_tpu_torch.train at R-50 1024^2 batch 8 bf16,
               clamp 6.0, 3 warm-up and 5 timed steps: finite losses,
               ms/step, img/s, peak memory, launches per step of every
               kernel (AlignConv fwd/bwd 5, BN moments/pair/apply/dx 53,
               IoU 2), and a profiler table of one step with the device's
               idle share; then the IoU kernel at the assignment shape, one
               call for the batch of 8 (shared anchors as the FAM stage,
               per-image anchors as the ODM stage), against its bound
 10. step vs plain  one R-18 256^2 batch-2 f32 train step (TF32 off, cuDNN
               deterministic), same weights and batch: the kernel path's
               loss items within 1e-4 (relative) of the plain path's; on
               the kernel path's forward, every gradient from the backward
               kernels within 1e-3 (of its largest value) of the gradient
               from the plain backward; the all-plain path's gradients and
               their spread under a 1e-7 input perturbation are reported
 11. evaluation  a synthetic DOTA-format set written without cv2 or PIL
               (16 1024^2 PNG chips from a zlib writer, their BGR .npy
               sidecars and YOLO labels of drawn rotated rectangles; a
               3000x4000 RGB .npy scene with its DOTA labelTxt), then
               python -m s2anet_tpu_torch.val on the chips (R-50, 15
               classes, bf16, batch 8, score_thr 0.005): map50, precision
               and recall finite in [0, 1], every chip's entry, AlignConv 5
               and NMS mask and sweep 1 launch a batch, images/s end to end
               (the 16 chips, then listed 32 times: 64 batches); over the
               512 listed chips, 3 runs each in turns: the loader's own
               rate with 1 and 4 workers (no model), and the runner's
               pinned pipeline against a plain synchronous step;
               python -m s2anet_tpu_torch.predict --mode chips on the
               scene: 20 windows at gap 200, merged polygons in the frame,
               seconds split into model and merge, and in float32
               (TF32 off) the kernel path's merged detections against the
               plain path's, >= 95% matched 1:1 by (label, score, centre
               within 1 px); and under the metric: the chips relabelled
               with a plain path's own detections (each class's 64 best),
               every path scored against them in merge mode (mAP50 over the
               classes that have labels): each plain path 1.0 by
               construction, the float32 kernel path >= 0.95 against the
               float32 plain path's labels, the bf16 kernel path >= 0.90
               against the bf16 plain path's, and against the float32
               labels of each of 6 random models (seeds 0-5) the bf16
               kernel path's mAP50 less the bf16 plain path's, their
               median within 0.02 (bf16 reorders random-weight near-ties:
               one model's gap is one draw)
 12. training run  32 train and 16 val synthetic 1024^2 DOTA-format chips
               (s2anet_tpu_torch.data.synth, 15 classes), then
               python -m s2anet_tpu_torch.train --config (configs/dota_r50.yaml
               with save_period 1) --data-root --val-root --epochs 2
               --batch-size 8: two results.csv rows with finite train and val
               losses and a val mAP50; weights/last, best, deploy; launches
               per train step as phase 9's (AlignConv 5/5, BN moments, pair,
               apply and dx 53 each, IoU 2) and per validation batch
               (AlignConv forward 5, IoU 2, NMS mask and sweep 1); the
               training plots (plots on, as the config has them): labels.png
               960x1200, train_batch0-2.png 1920x1920 (8 chips, 640^2 tiles),
               pr_curves.png 720x960 and results.png 1440x1920, each read back
               by data/image.py at that size, the plots' host seconds beside
               the epoch loop's ms/step (which takes the three mosaics, drawn
               while the device runs their steps: printed with and without
               their seconds); a
               --resume from weights/epoch0 (4 times) runs epoch 1 only, with
               8 updates and the same LR, the straight run's train losses
               within 5% of the resumed runs' mean plus 3 of their standard
               deviations; python -m
               s2anet_tpu_torch.val --weights weights/deploy on the val chips
               (folded BN) within 0.02 mAP50 of the trainer's last
               validation; the first resumed run draws its mosaics again, the
               later ones and the steady epochs below run with --noplots and
               write no plot. Prints the loop's ms/step (both epochs, and each
               epoch to the device's end) beside phase 9's, the host's wait
               for the loader per step, the loader's augmented images/s
               alone (3 epochs), validation seconds and peak memory; then one
               16-step epoch (128 chips, no validation) with 4 and with 1
               loader threads: ms/step, the host's wait for the loader and
               its median time to enqueue a step
 13. int8 serving  on phase 11's chips (then deleted): R-50 1024^2 batch 8
               bf16, folded BN, calibrated on 4 batches, in the default scope
               (backbone, neck, head_stacks) and the full one (+ orconv,
               heads): launches a serving batch (quantiser and int8 conv 100
               / 125, AlignConv 5); on every distinct quantised conv and
               activation shape of a batch, both kernels against their plain
               versions, bit for bit; per shape the conv kernel's time against
               its bound (bytes over 3.35 TB/s or int8 operations over 1,979
               TOPS) with torch._int_mm (1x1, or a prebuilt im2col for 3x3,
               not timed) and cuDNN's bf16 convolution of the shape as
               yardsticks, and, given --parent (a checkout of an earlier
               tree), that tree's int8 conv timed in turns with this one,
               summed over a batch (table in --out chip_smoke_int8.txt);
               the kernel's registers and spills (-Xptxas -v); the host's
               enqueue time of one quantised conv (quantiser and conv
               wrappers; the earlier tree's beside it); the quantiser
               against its byte bound;
               at batch 2 the kernel path against the path with the int8
               convs and quantiser plain (>= 95% of detections matched 1:1
               by rotated IoU >= 0.5); int8 against bf16 head outputs in
               units of max(|bf16|, 0.05): odm_cls within 0.07 (the JAX
               package's R-18 bar), odm_bbox within 0.5 (the JAX package's
               own R-50 int8 path moves it 0.28 at 128^2); chips/s of
               bf16, int8 default and int8 full at score_thr 0.05 and 0.005 in
               turns; a profiled batch of each (launches, idle share); python
               -m s2anet_tpu_torch.val --quant int8 on the chips (launches,
               mAP50 against the labels made from the bf16 plain path) and
               over the listed chips (images/s beside phase 11's bf16)
 14. rect serving  24 synthetic images of HRSC2016's aspect ratios (600x1000
               to 1100x900; PNG from the zlib writer, BGR .npy sidecars, YOLO
               labels of 1 class, HRSC Annotation XML), configs/hrsc_r50.yaml
               (R-50, 1 class, 800, bf16, batch 8, folded BN, seeded weights,
               score_thr 0.005): the rect plan (more than one target shape,
               each a multiple of 32, fewer pixels than square batches);
               images/s of evaluate_on_chips with rect and square batches over
               the images listed 8 times, 3 runs each in turns, each with its
               first batch's seconds and those of the batches at a new shape
               (cuDNN autotuning) apart; python -m s2anet_tpu_torch.val
               --config configs/hrsc_r50.yaml --rect: the plan's shapes,
               AlignConv 5 and NMS mask and sweep 1 launch a batch, map50,
               precision and recall finite in [0, 1], every image's entry,
               evaluate_hrsc against the XML finite; on one batch of each
               target shape, in bf16 and float32 (TF32 off): the kernel path
               against the plain path (bf16 >= 95% matched 1:1 by rotated IoU,
               float32 by centre), the AlignConv forward at each level against
               its plain version (phase 3's tolerances), and the NMS mask bits
               and keeps on the batch's candidates; evaluate_hrsc against XML
               made from the bf16 plain path's 64 best detections (plain path
               1.0, kernel path >= 0.90); val --rect --quant int8: 100
               quantiser and int8 conv launches a batch, both kernels bit-equal
               to their plain versions on every shape the run met; a
               weights/last of train/checkpoint.py whose EMA and model
               weights differ, through val --weights with and without
               --no-ema: both load, the detections differ
 15. options   the Trainer's model and data options. a: R-50 1024^2 batch 8
               bf16 (phase 9's batch, clamp 6.0), the default configuration
               and frozen_stages 1, norm_eval, bn_stats_images 2 and
               with_orconv false (the bench's flags), each a warm-up and 3
               timed train steps on the kernel path; before each, the plain
               path's forward, loss and backward on a copy of the model's
               state (plain AlignConv, BN and IoU); then the same in float32
               (TF32 off): the kernel path's loss items within 1e-4
               (relative) of the plain path's loss on the kernel path's
               assignment codes, and the assignment's IoUs within 1e-3 on
               both paths, the anchors of codes that differ too, so that
               codes differ only where an IoU or an anchor lies that near a
               threshold of the rule (the codes that
               differ, each path's loss on its own codes and the bf16 gaps
               are printed), the BNs in inference mode keeping
               their running statistics on both paths, BN launches a step
               (moments / pair / apply / dx 53, 42, 0, 53 with dx 106, 53),
               AlignConv 5 + 5, IoU 2; bf16 ms/step of each beside the
               default's. b: the
               sampled-statistics kernels (prefix 2 of 8) at the 53 R-50 BN
               shapes, f32 and bf16, against the plain finishing on the
               kernel's sums (1e-6) and apply and the two-range dx bit for
               bit; the stats kernel's device time over the 53 inputs on
               the prefix against the full batch. c: 16 train and 8 val
               synthetic chips, python -m s2anet_tpu_torch.train --config
               (configs/dota_r50.yaml with mosaic 0.5, translate 0.1, scale
               0.5, loader process), one epoch of 2 steps and validation:
               finite losses, mAP50 in [0, 1], loader processes alive
               during the steps; then the augmented loader alone over the
               chips listed 4 times, process and thread mode in turns
               (images/s)
 16. data parallel  the BN kernels' data-parallel mode at the 53 R-50 BN
               shapes, bf16 and float32, statistics from none (another
               rank's), 2 or all 8 images: the sums alone, then the fused
               finishing kernels s2a_bn_apply_finish / s2a_bn_dx_finish, equal
               bit for bit to the one-launch sums and finishing followed by
               s2a_bn_apply / s2a_bn_dx on the two row ranges (one launch of
               each fused kernel a call); against their plain versions on the
               same sums (per-channel outputs within 1e-5, y and dx within one
               ulp of the largest value); zero rows give zero sums; over a
               step's 53 bf16 layers each fused kernel in turns with the
               kernel it replaces alone (events over the sweep; device time,
               profiler; the host's enqueue), its bound, its plain version,
               and torch.batch_norm_backward_elemt (dx from all-reduced sums).
               a: two ranks
               spawned (spawn start method) on the one card over gloo, R-50
               1024^2, global batch 8 (4 a rank), from the seeded state: 2
               float32 train steps (TF32 off, deterministic cuDNN), each
               held against one process at batch 8 from the state rank 0
               had before it, on the ranks' assignment codes: every BN
               layer's forward mean and var (per channel, the mean over its
               standard deviation, the var over itself) within 1e-5 of the
               statistics of the ranks' own inputs (float64 sums, apart from
               the kernels) and within 1e-4 of one process's (whose inputs
               drift with the layers before), the FAM positives over the
               global batch exact and the ODM ones within the codes that
               differ (printed), the gradient summed over the ranks within
               1e-3 of one process's (relative to its norm), loss items
               within 1e-4; then bf16 ms/step of the two ranks against one
               process at batch 8, and each kernel's launches a step on
               rank 0 (fused apply and dx 53 + 53, s2a_bn_apply / s2a_bn_dx
               0); given --parent, that tree's steps in turns with this
               one's (parent, this, this, parent), in the ranks and in one
               process, and a profiled step of each tree (cuDNN without
               autotuning): in one process the same launches name for name,
               on rank 0 106 fewer (the finishing kernels gone). b: torchrun
               --standalone --nproc_per_node 2 -m s2anet_tpu_torch.train
               --config configs/dota_r50.yaml on 16 train and 8 val synthetic
               chips, one epoch: one summary from rank 0, rank-0 validation,
               one results.csv row, weights/last, best, deploy with keys
               without 'module.'; that weights/last resumed by one process
               for epoch 1; val on the deploy weights. c: with 2 or more
               cards, a over NCCL, one card a rank, with ms/step against
               one card; skipped (and said so) on one card
 17. spatial   predict --mode spatial (each image whole, its height sharded
               over torchrun's ranks), R-50, configs/dota_r50.yaml (clamp
               6.0), on weights seeded as the other phases' with the ODM class
               head's kernel scaled so that 1e-4 of a scene-like image's
               scores pass predict's 0.3 (scores spread over (0, 1), not
               within 1e-5 of the prior, so two float32 paths order them
               alike).
               b: torchrun --nproc_per_node 2 -m s2anet_tpu_torch.predict
               --mode spatial, the two ranks sharing the card over gloo, on a
               1000x1400 scene (padded to 1024x1408 on 1 and 2 ranks):
               float32 at clamp 6.0 (halo) and 0 (gathered levels), with
               TF32 off, at a score threshold in a gap of the scores, and bf16
               at clamp 6.0 on the seeded weights at score_thr 0.005, the
               three runs at once, each against this process (one rank, the
               CLI's cudnn.benchmark) on the same scene and weights: float32
               valid and
               labels equal, scores and polygon vertices within rtol 1e-4 /
               atol 1e-3 (plus the file's rounding), bf16 >= 95% matched 1:1
               by (label, score, rotated IoU >= 0.5); rank 0's launches
               (AlignConv 5, NMS mask and sweep 1). c: the AlignConv kernel on
               the blocks each rank builds (halo rows or the gathered level;
               the exchanges served in this process) at 17b's P3 and the
               scene's P3 on 2 ranks, P5 and P7 (thinner than the halo) on 4,
               P4 at clamp 0: f32 within 1e-5 of the largest value of the
               unsharded kernel's output (h / 128 x 1e-5 on a level of h >
               128 rows, whose float32 tap rows round with their magnitude),
               bf16 within 2e-2. a: one process, bf16:
               phase 11's 3000x4000 scene (padded to 3072x4096) and a
               4096x4096 one with cudnn.benchmark off, the scene turned and
               a 4224x3968 one with it on (shapes of their own: cuDNN keeps
               the first algorithm a shape met), each shape's first scene
               and 3 repeats (the order alternating), peak
               memory of each scene (and of chips mode), the scene's seconds
               in spatial and chips mode in turns (5 each; model and decode
               or merge apart) at predict's score_thr 0.3, then on the
               seeded weights at score_thr 0.005 (as phases 5 and 11) the
               kernel path against the plain path (>= 95% matched 1:1 by
               rotated IoU) with the scene's launches (AlignConv 5, NMS mask
               and sweep 1), the spatial forward's launches on one rank equal
               to the model's forward's on the padded scene name for name
               (profiler), and the AlignConv kernel's time at the scene's
               P3-P7 against its bound
 18. images    the image-file and dataset-preparation path, without cv2 or
               PIL: two 1500x2000 DOTA-layout scenes written as PNG (the
               five row filters in turn, encoded in NumPy) with their
               labelTxt; data/image.py reads one back to its pixels (MB/s
               of the whole read, of the C++ unfilter and of zlib's inflate
               alone); python -m s2anet_tpu_torch.tools.prepare_dota --rates
               0.5 1.0 (4 workers): chips per split equal to window_origins',
               no sidecar, and one scene's split seconds at each rate in one
               process; val on val_split.txt with every chip read by
               data/image.py; predict on the PNG scenes with --save-img
               (R-50, bf16, score_thr 0.005, cudnn deterministic), its
               <name>.txt and the 15 Task1 files byte-equal to predict
               --npy on the same RGB pixels in this process, launches a
               batch (AlignConv 5, NMS mask and sweep 1), the drawn PNGs
               decoding at the scene's size; nms_rotated / ml_nms_rotated
               on 4096 clustered candidates with tied scores (valid all,
               70%, none) equal to the plain keep, one mask and one sweep
               launch a call
 19. export and tools  python -m s2anet_tpu_torch.export's path on the card:
               R-50 1024^2 bf16 batch 8 (score_thr 0.005) through
               torch.export, its graph holding the s2anet custom ops 5 / 1 /
               1 (AlignConv forward, NMS mask, NMS sweep), saved; reloaded
               in this process, bit-equal to S2ANetPredictor.predict on the
               same batch, launching the kernels 5 / 1 / 1; reloaded in a
               child process that imports only s2anet_tpu_torch.ops.library
               (no models/ module), cuDNN autotuning off in both, bit-equal
               again; a profiled batch of the reloaded program with the hand
               kernels 5 / 1 / 1 and within 10 launches of the eager
               module (its anchor grids are constants of the program; a
               plain version would add hundreds); eager against
               exported chips/s in turns (median of 5, spread), and given
               --parent, eager predict() against that tree's in turns; the
               GFLOP/chip of utils/flops.py on the exported graph after
               dead-code removal and as executed, the measured bf16 matmul
               peak and the model-FLOP share at phase 6's rate;
               tools/profile_report on a traced serving batch and a traced
               R-50 train step, each device total within 1% of the
               profiler's key_averages(), top 15 kernels; python -m
               s2anet_tpu_torch.tools.quant_scope_bench over its 5 scopes
               (2 rounds of 3 batches); python -m
               s2anet_tpu_torch.tools.visualize on 4 of phase 18's val
               chips (phase 17's weights); the phase's seconds
 20. PAN neck  R-50 1024^2 bf16 serving (folded BN, seeded weights) with
               its neck replaced by PAN((512, 1024, 2048), 256, 5) (a
               harness in this phase: no config selects PAN), on 8 seeded
               1024^2 chips. a: the PAN alone on the backbone's C3-C5, bf16
               channels-last against its own weights in float32 (TF32 off),
               each level within 2e-2 of the float32 level's largest
               magnitude; the PAN's ms a batch in turns with its inner FPN's
               (CUDA events) and the launches of each (profiler; the PAN's
               more than the FPN's). b: the
               serving path behind the PAN at score_thr 0.005, the kernel
               path against the plain path (>= 95% of detections matched 1:1
               by rotated IoU >= 0.5), AlignConv 5 and NMS mask and sweep 1
               launch a batch; chips/s with the PAN neck and with the FPN
               neck in turns. c: the PAN model in int8 (neck scope),
               calibrated on 4 batches: quantiser and int8 conv 14 launches a
               batch each, both kernels bit-equal to their plain versions on
               every distinct shape of a batch, each conv's time against its
               bound (bytes over 3.35 TB/s or int8 operations over 1,979
               TOPS) with its plan, and the PAN convs' and the quantiser's
               ms a batch against their bounds

The line before the last is ``{"kernels": [...]}``: per kernel its launches
on its path (training, or serving for the NMS kernels, ``val --quant int8``
for the int8 kernels; ``eval_launches``: the val run of phase 11 for the
kernels on that path; ``rect_launches``: the ``val --rect`` run of phase 14,
``val --rect --quant int8`` for the int8 kernels; ``option_launches``: a
train step of each configuration of phase 15; ``dp_launches``: a step of
phase 16a on rank 0, which is the fused finishing kernels' path; ``spatial_launches``:
a 3072x4096 scene of phase 17a, with the AlignConv's time at its levels
beside; ``image_launches``: a batch of phase 18's predict on PNG scenes;
``export_launches``: a batch of phase 19's reloaded exported program;
``pan_launches``: a serving batch behind phase 20's PAN neck, its int8
batch for the int8 kernels, beside their ``pan_ms`` and ``pan_bound_ms``
a batch), its
largest error
against the plain version, its time, the plain version's and the library
call's time where there is one, and the least time the card could take
(``bound_ms``: the larger of the bytes over 3.35 TB/s and the operations
over 989 TFLOP/s bf16, 1,979 TOPS int8 or 67 TFLOP/s f32, H100 SXM). Every time is the
median of 5 timed loops (CUDA events); lines give the spread. The last
line is ``{"ok": true, "device": {...}}``. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH, SIZE, SEED = 8, 1024, 0
REPEATS = 5  # timed loops per measurement; the median is reported
GT_PER_CLASS = 64  # phase 11: labels per class from the plain path's detections
LISTED = 32  # phase 11: the chips listed this many times for the timed runs
TURNS = 3  # phase 11: timed runs of each variant, in turns
MODELS = 6  # phase 11: random models (seeds) over which the two bf16 paths' mAP50 is compared
# H100 SXM peaks (NVIDIA's data sheet; full rates at 700 W)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
# float32 operations of one iou_pair (csrc/iou_nms_rotated.cu), counted
# with a division or a transcendental as one: a pair past the bounding-
# circle test (two clip passes of 4 edges x 4 half-planes, ~30 each, plus
# the corners) and a pair the test rejects
IOU_PAIR_OPS, IOU_REJECT_OPS = 1100, 15


START = time.perf_counter()


def say(msg: str) -> None:
    """Print a line; a phase's heading also gets the seconds since the
    script started (the whole run must end within the card call's limit)."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - START:.0f} s]"
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    say(f"   {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        raise Failed(what)


def loop_ms(torch, fn, iters: int) -> float:
    """Device milliseconds per run of ``fn`` over one loop of ``iters`` runs,
    from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(torch, fn, iters: int, repeats: int = REPEATS):
    """``(median, spread)`` of the device milliseconds per run of ``fn``
    over ``repeats`` timed loops of ``iters`` runs, after one warm-up;
    spread = (slowest - fastest) / median of the loops."""
    fn()
    torch.cuda.synchronize()
    return median_spread([loop_ms(torch, fn, iters) for _ in range(repeats)])


def host_ms(torch, fn, repeats: int = REPEATS) -> float:
    """Median host milliseconds to enqueue ``fn`` on an idle device (the
    clock stops before the device finishes)."""
    ts = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return median_spread(ts)[0]


def median_spread(ts):
    ts = sorted(ts)
    med = ts[len(ts) // 2]
    return med, (ts[-1] - ts[0]) / med if med > 0 else 0.0


def paired_ms(torch, fa, fb, iters: int, repeats: int = REPEATS):
    """Two functions timed in turns (a, b, a, b, ...) after a warm-up of
    each: ``((median, spread) of a, (median, spread) of b)``."""
    fa()
    fb()
    torch.cuda.synchronize()
    ta, tb = [], []
    for _ in range(repeats):
        ta.append(loop_ms(torch, fa, iters))
        tb.append(loop_ms(torch, fb, iters))
    return median_spread(ta), median_spread(tb)


def bound(nbytes: float, ops: float, flop_s: float):
    """(ms, "bytes" | "operations"): the least time of a kernel that reads
    and writes ``nbytes`` once and does ``ops`` at ``flop_s``."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_S
    t_ops = 1e3 * ops / flop_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def iou_ops(torch, b1, b2):
    """Operations of the IoU kernel on [N, 5] x [M, 5]: pairs whose
    bounding circles meet (and with nonzero areas) run the full routine."""
    r1 = 0.5 * torch.sqrt(b1[:, 2] ** 2 + b1[:, 3] ** 2)
    r2 = 0.5 * torch.sqrt(b2[:, 2] ** 2 + b2[:, 3] ** 2)
    d2 = torch.cdist(b1[:, :2].double(), b2[:, :2].double()) ** 2
    full = ((d2 <= (r1[:, None] + r2[None, :]).double() ** 2)
            & (b1[:, 2:4].prod(1) > 1e-14)[:, None]
            & (b2[:, 2:4].prod(1) > 1e-14)[None, :]).sum().item()
    return full * IOU_PAIR_OPS + (b1.shape[0] * b2.shape[0] - full) * IOU_REJECT_OPS


def match_1to1(a, la, b, lb, iou=None) -> int:
    """Greedy 1:1 matches of detections ``a`` to ``b`` on (label, score
    within 1e-3, centre within 1 px), as tests/test_reference_parity.py
    matches them; with ``iou [len(a), len(b)]`` given, on (label, score
    within 1e-3, rotated IoU >= 0.5) instead, the best IoU first."""
    used = np.zeros(len(b), bool)
    matched = 0
    for i in range(len(a)):
        near = (np.linalg.norm(b[:, :2] - a[i, :2], axis=1) < 1.0 if iou is None
                else iou[i] >= 0.5)
        cand = np.nonzero((~used) & (lb == la[i])
                          & (np.abs(b[:, 5] - a[i, 5]) < 1e-3) & near)[0]
        if len(cand):
            used[cand[0] if iou is None else cand[np.argmax(iou[i, cand])]] = True
            matched += 1
    return matched


def unpack_mask(torch, mask, k):
    """``[B, K, ceil(K/64)]`` int64 words -> ``[B, K, K]`` bool."""
    bits = (mask[..., None] >> torch.arange(64, device=mask.device)) & 1
    return bits.reshape(mask.shape[0], k, -1)[:, :, :k].bool()


def mask_bits_differing(torch, nms, boxes, labels, valid, thr):
    """``(bits differing, suppressing pairs)``: the NMS mask kernel's bits of
    the valid rows, from each row's own word on (the words the sweep reads),
    against ``overlap_plain``."""
    b, k = valid.shape
    bits = unpack_mask(torch, nms.nms_mask_cuda(boxes, labels, valid, thr), k)
    torch.cuda.synchronize()
    idx = torch.arange(k, device=boxes.device)
    read = (idx[None, :] // 64) >= (idx[:, None] // 64)
    over = nms.overlap_plain(boxes, labels, valid, thr, k)
    return ((bits & read) != over)[valid].sum().item(), int(over.sum())


def mask_bound(torch, boxes, labels, valid):
    """``(ms, by)``: the NMS mask's bound on ``[B, K]`` score-sorted
    candidates. The pairs j > i of valid candidates with equal labels run
    the IoU routine (at full cost where the bounding circles meet); it
    reads the candidates and writes the words on and above the diagonal."""
    b, k = valid.shape
    n = int(valid.sum(1).max())
    ops = 0
    for i in range(b):
        vi = valid[i, :n]
        same = ((labels[i, :n, None] == labels[i, None, :n]) & vi[:, None] & vi[None, :]).triu(1)
        bx = boxes[i, :n]
        r = 0.5 * torch.sqrt(bx[:, 2] ** 2 + bx[:, 3] ** 2)
        near = (torch.cdist(bx[:, :2].double(), bx[:, :2].double())
                <= (r[:, None] + r[None, :]).double())
        full = (same & near).sum().item()
        ops += full * IOU_PAIR_OPS + (same.sum().item() - full) * IOU_REJECT_OPS
    cols = (k + 63) // 64
    words = b * 64 * sum(cols - rb for rb in range(cols))
    return bound(b * k * (5 * 4 + 4 + 1) + 8 * words, ops, F32_FLOP_S)


def sweep_rounds(over, valid):
    """``(rounds, most in a block, blocks)`` of the sweep kernel's round rule
    on candidates with suppression matrix ``over [B, n, n]``, replayed in
    numpy (a model of the rule; the kernel reports no count): per 64-row
    block, rounds in which a row becomes alive once every unblocked row that
    suppresses it is dead, dead once one is alive, until no row is open."""
    over = over.cpu().numpy()
    valid = valid.cpu().numpy()
    total = worst = blocks = 0
    for b in range(over.shape[0]):
        removed = ~valid[b]
        for c0 in range(0, over.shape[1], 64):
            rows = slice(c0, c0 + 64)
            blocked = removed[rows].copy()
            sup = over[b][rows, rows] & ~blocked[:, None]  # [i, j]: i suppresses j
            alive = np.zeros(len(blocked), bool)
            dead, open_ = blocked.copy(), ~blocked
            r = 0
            while open_.any():
                a = open_ & ~(sup & ~dead[:, None]).any(0)
                d = open_ & (sup & alive[:, None]).any(0)
                alive |= a
                dead |= d
                open_ &= ~(a | d)
                r += 1
            total, worst, blocks = total + r, max(worst, r), blocks + (r > 0)
            removed = removed | over[b][rows][alive].any(0)
    return total, worst, blocks


def short_name(key: str) -> str:
    """A kernel's name without its arguments and namespace."""
    return key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def degenerate_boxes(torch, dev):
    """Identical, grid-touching, stacked-touching, shared-edge, contained
    and zero-size boxes (tests/test_pallas_iou.py)."""
    s = 8.0
    rows = [[x * s, y * s, 4 * s, 4 * s, 0.0] for x in range(4) for y in range(4)]
    rows += [[100.0, 100.0, 80.0, 40.0, 0.0], [100.0, 130.0, 60.0, 20.0, 0.0],
             [50.0, 50.0, 100.0, 40.0, 0.0], [80.0, 50.0, 60.0, 40.0, 0.0],
             [10.0, 10.0, 50.0, 30.0, 0.3], [10.0, 10.0, 20.0, 10.0, 0.3]]
    rows += [[0.0] * 5] * 3
    return torch.tensor(rows, dtype=torch.float32, device=dev)


def clustered_candidates(torch, gen, b, k, dev):
    """Score-sorted NMS candidates that overlap a lot: boxes jittered around
    a few centres per image, 15 labels, a valid prefix per image."""
    ctr = torch.rand(b, 40, 2, generator=gen, device=dev) * 900 + 60
    pick = torch.randint(0, 40, (b, k), generator=gen, device=dev)
    xy = torch.gather(ctr, 1, pick[..., None].expand(-1, -1, 2))
    xy = xy + torch.randn(b, k, 2, generator=gen, device=dev) * 6
    wh = torch.rand(b, k, 2, generator=gen, device=dev) * torch.tensor(
        [60.0, 30.0], device=dev) + torch.tensor([20.0, 10.0], device=dev)
    ang = (torch.rand(b, k, 1, generator=gen, device=dev) - 0.5) * 1.2
    boxes = torch.cat([xy, wh, ang], -1)
    labels = torch.randint(0, 15, (b, k), generator=gen, device=dev)
    n_valid = torch.tensor([k, k, k // 2, 700, 64, 1, 0, k - 37][:b], device=dev)
    valid = torch.arange(k, device=dev)[None] < n_valid[:, None]
    return boxes, labels, valid


def bn_input_shapes(torch, arch: str, batch: int, size: int):
    """[N, C, H, W] of every BatchNorm input of the backbone, in order, from
    a forward on the meta device (no memory, no kernels)."""
    from s2anet_tpu_torch.models.bn import BatchNorm2d
    from s2anet_tpu_torch.models.resnet import ResNet

    net = ResNet(arch).to("meta").eval()
    shapes = []
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, inp: shapes.append(tuple(inp[0].shape)))
    with torch.no_grad():
        net(torch.empty(batch, 3, size, size, device="meta"))
    return shapes


LEVELS = ("P3", "P4", "P5", "P6", "P7")


def gather_bytes(cells: int, c: int) -> int:
    """Bytes the bf16 AlignConv gather reads (L1/L2 side): 9 taps x 4
    corners x C channels x 2 bytes per cell."""
    return cells * 9 * 4 * c * 2


def scatter_bytes(cells: int, c: int) -> int:
    """float32 bytes the dx scatter reduces into dx: 9 taps x 4 corners x C
    channels x 4 bytes per cell (corners outside the image are skipped)."""
    return cells * 9 * 4 * c * 4


def rate(amount: float, ms: float) -> float:
    """``amount`` per millisecond in units of 1e9 per millisecond (TFLOP/s or
    TB/s for FLOP or bytes); nan for a time of 0."""
    return amount / ms / 1e9 if ms > 0 else float("nan")


def kernel_split(torch, fn, runs: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` of each kernel it launches,
    from the profiler (one warm-up call first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / 1000 / runs
    return out


def launches_by_name(torch, fn) -> dict:
    """Per name, the kernels, copies and fills one call of ``fn`` puts on
    the device (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_launches(torch, fn) -> int:
    """Kernels, copies and fills that one call of ``fn`` puts on the device
    (profiler; one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    return sum(launches_by_name(torch, fn).values())


def phase_deform_bwd(torch, dev, gen, levels):
    """Kernel 3 against autograd of the plain forward; P3-P7 times."""
    from s2anet_tpu_torch.ops import deform_conv as dc

    say("== 7. kernel 3: AlignConv backward vs plain")
    worst = 0.0
    cases = [  # name, (b, h, w, c, cout), offset scale, dtype, tolerance
        ("P3 f32", (2, 128, 128, 256, 256), 1.5, torch.float32, 1e-3),
        ("P3 bf16", (2, 128, 128, 256, 256), 1.5, torch.bfloat16, 2e-2),
        ("odd 19x41 C40->24", (1, 19, 41, 40, 24), 6.0, torch.float32, 1e-3),
        ("odd 19x41 C40->24 bf16", (1, 19, 41, 40, 24), 6.0, torch.bfloat16, 2e-2),
        ("1x1", (2, 1, 1, 256, 256), 3.0, torch.float32, 1e-3),
        ("odd 3x37 bf16", (3, 3, 37, 256, 256), 6.0, torch.bfloat16, 2e-2),
        ("P7 bf16", (8, 8, 8, 256, 256), 1.5, torch.bfloat16, 2e-2),
        ("1x1 bf16", (2, 1, 1, 256, 256), 3.0, torch.bfloat16, 2e-2),
        ("odd 19x41 C264->264 bf16", (1, 19, 41, 264, 264), 3.0, torch.bfloat16, 2e-2),
    ]
    for name, (b, h, w, c, co), scale, dtype, tol in cases:
        x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
        off = torch.randn(b, h, w, 9, 2, generator=gen, device=dev) * scale
        off[:, : max(1, h // 4), :, :3, 0] -= 500.0  # far outside: no gradient
        off = off.to(dtype)
        wt = (torch.randn(3, 3, c, co, generator=gen, device=dev) * 0.05).to(dtype)
        g = torch.randn(b, h, w, co, generator=gen, device=dev).to(dtype)
        dx, dw = dc.deform_conv2d_bwd_cuda(x, off, wt, g)
        torch.cuda.synchronize()
        rx, rw = dc.deform_conv2d_bwd_plain(x, off, wt, g)
        errs = []
        for got, ref in ((dx, rx), (dw, rw)):
            err = (got.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            errs.append((err, top, got.dtype == dtype and err <= tol * top))
        if dtype == torch.bfloat16:
            worst = max(worst, errs[0][0], errs[1][0])
        check(errs[0][2] and errs[1][2],
              f"{name}: dx max |kernel - plain| {errs[0][0]:.3g} (max |dx| {errs[0][1]:.3g}), "
              f"dW {errs[1][0]:.3g} (max |dW| {errs[1][1]:.3g}); bound {tol} x max")
    x = torch.randn(2, 32, 32, 256, generator=gen, device=dev).bfloat16()
    off = (torch.randn(2, 32, 32, 9, 2, generator=gen, device=dev) * 1.5).bfloat16()
    wt = (torch.randn(3, 3, 256, 256, generator=gen, device=dev) * 0.05).bfloat16()
    g = torch.randn(2, 32, 32, 256, generator=gen, device=dev).bfloat16()
    dws = [dc.deform_conv2d_bwd_cuda(x, off, wt, g)[1] for _ in range(3)]
    check(all(torch.equal(dws[0], d) for d in dws[1:]),
          "bf16 dW of three runs on the same inputs: equal bit for bit")
    grads = [torch.randn(x.shape[:3] + (wl.shape[-1],), generator=gen,
                         device=dev).bfloat16() for x, _, wl in levels]
    t_k, s_k = cuda_ms(torch, lambda: [dc.deform_conv2d_bwd_cuda(*a, g)
                                       for a, g in zip(levels, grads)], 5)
    t_p, _ = cuda_ms(torch, lambda: [dc.deform_conv2d_bwd_plain(*a, g)
                                     for a, g in zip(levels, grads)], 1)
    nbytes = ops = 0
    for (x, _, wl), g in zip(levels, grads):
        cells, c, co = x.numel() // x.shape[-1], x.shape[-1], wl.shape[-1]
        nbytes += cells * (2 * c + 18 * 4 + 2 * co + 2 * c) + 9 * c * co * (2 + 4)
        ops += 2 * 2 * cells * 9 * c * co
    b_ms, b_by = bound(nbytes, ops, BF16_FLOP_S)
    say(f"   deform_conv2d backward P3-P7 (one batch of 8, bf16): kernel {t_k:.3f} ms "
        f"(median of {REPEATS}, spread {s_k:.1%}), plain {t_p:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}: {ops / 1e9:.0f} GFLOP, {nbytes / 1e6:.0f} MB)")
    # per level: the four launches of one backward, from the profiler
    split_sum: dict = {}
    for name, (x, o, wl), g in zip(LEVELS, levels, grads):
        cells, c, co = x.numel() // x.shape[-1], x.shape[-1], wl.shape[-1]
        t_l, _ = cuda_ms(torch, lambda x=x, o=o, wl=wl, g=g:
                         dc.deform_conv2d_bwd_cuda(x, o, wl, g), 5)
        part = {"dW": 0.0, "dx": 0.0, "finish": 0.0, "memset": 0.0}
        for key, ms in kernel_split(torch, lambda x=x, o=o, wl=wl, g=g:
                                    dc.deform_conv2d_bwd_cuda(x, o, wl, g)).items():
            grp = ("dW" if "dw_bf16" in key else "dx" if "dx_bf16" in key
                   else "finish" if "finish" in key else "memset" if "Memset" in key else None)
            if grp:
                part[grp] += ms
        for k, v in part.items():
            split_sum[k] = split_sum.get(k, 0.0) + v
        flop = 2 * cells * 9 * c * co
        say(f"   {name} {tuple(x.shape)}: backward {t_l:.4f} ms; dW {part['dW']:.4f} ms "
            f"({rate(flop, part['dW']):.1f} TFLOP/s, gathered "
            f"{rate(gather_bytes(cells, c), part['dW']):.2f} TB/s), dx {part['dx']:.4f} ms "
            f"({rate(flop, part['dx']):.1f} TFLOP/s, reduced "
            f"{rate(scatter_bytes(cells, c), part['dx']):.2f} TB/s), finish "
            f"{part['finish']:.4f} ms, memset {part['memset']:.4f} ms")
    say(f"   P3-P7 split (profiler): dW {split_sum['dW']:.3f} ms, dx {split_sum['dx']:.3f} ms, "
        f"finish {split_sum['finish']:.3f} ms, memset {split_sum['memset']:.3f} ms")
    return dict(max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def rel_to_max(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def phase_moments(torch, dev, gen):
    """Kernels 5 and 6 with their finishing steps, and the BN apply and dx
    kernels, against their plain versions; times over the BN inputs of one
    R-50 step against the library calls."""
    import torch.nn.functional as F

    from s2anet_tpu_torch.models.bn import BatchNorm2d
    from s2anet_tpu_torch.ops import moments as mo

    say("== 8. kernels 5, 6 (BN sums and finishing) and the BN apply and dx kernels vs plain")
    eps, keep = 1e-5, 0.9
    worst = {"moments": 0.0, "pair": 0.0, "apply": 0.0, "dx": 0.0}
    for shape in ((8, 512, 512, 64), (8, 32, 32, 2048), (3, 5, 7, 24), (2, 1, 1, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            c = shape[-1]
            n = int(np.prod(shape[:-1]))
            x = (torch.rand(shape, generator=gen, device=dev) * 2 + 0.3).to(dtype)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            weight = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = torch.randn(c, generator=gen, device=dev) * 0.3
            rm = torch.randn(c, generator=gen, device=dev) * 0.2
            rv = torch.rand(c, generator=gen, device=dev) + 0.5
            rm_p, rv_p = rm.clone(), rv.clone()
            tracked, tracked_p = (torch.tensor(0, device=dev) for _ in range(2))
            got = mo.channel_moments_cuda(x) + mo.grad_channel_sums_cuda(g, x)
            stats = mo.bn_stats_cuda(x, weight, rm, rv, tracked, eps, keep)
            mean, _, rstd, mul = stats
            grad = mo.bn_grad_cuda(g, x, mean, rstd)
            y = mo.bn_apply_cuda(x, mean, mul, bias)
            dx = mo.bn_dx_cuda(g, x, mean, mul, grad[2], grad[3])
            torch.cuda.synchronize()
            ref = mo.channel_moments_plain(x) + mo.grad_channel_sums_plain(g, x)
            xf, gf = x.float().reshape(-1, c), g.float().reshape(-1, c)
            mags = (xf.abs().sum(0), (xf * xf).sum(0), gf.abs().sum(0),
                    (gf * xf).abs().sum(0))
            rel = max(((a - r).abs() / m).max().item() for a, r, m in zip(got, ref, mags))
            # the finishing steps against the plain ones on the kernel's sums
            # (deterministic: the same chunks in the same order)
            ref_stats = mo.stats_from_sums(got[0], got[1], n, weight, rm_p, rv_p, tracked_p,
                                           eps, keep)
            ref_grad = mo.grad_from_sums(got[2], got[3], n, mean, rstd)
            outs_s, refs_s = stats + (rm, rv), ref_stats + (rm_p, rv_p)
            fin = max(rel_to_max(a, b) for a, b in zip(outs_s + grad, refs_s + ref_grad))
            worst["moments"] = max(worst["moments"], *(
                (a - r).abs().max().item() for a, r in zip(got[:2] + outs_s, ref[:2] + refs_s)))
            worst["pair"] = max(worst["pair"], *(
                (a - r).abs().max().item() for a, r in zip(got[2:] + grad, ref[2:] + ref_grad)))
            y_ref = mo.bn_apply_plain(x, mean, mul, bias)
            dx_ref = mo.bn_dx_plain(g, x, mean, mul, grad[2], grad[3])
            worst["apply"] = max(worst["apply"], (y.float() - y_ref.float()).abs().max().item())
            worst["dx"] = max(worst["dx"], (dx.float() - dx_ref.float()).abs().max().item())
            same_y, same_dx = torch.equal(y, y_ref), torch.equal(dx, dx_ref)
            check(rel <= 1e-5 and fin <= 1e-6 and int(tracked) == int(tracked_p) == 1
                  and same_y and same_dx,
                  f"{list(shape)} {str(dtype)[6:]}: sum, sum x^2, sum g, sum g*x within "
                  f"{rel:.3g} of the sums of magnitudes (bound 1e-5); mean, var, rstd, mul, "
                  f"running mean and var, dgamma, dbeta, a, b within {fin:.3g} of the plain "
                  f"finishing on the same sums (bound 1e-6), batch count {int(tracked)}; "
                  f"apply and dx equal to plain bit for bit: {same_y}, {same_dx}")
    del x, g, y, dx, y_ref, dx_ref, xf, gf
    shapes = bn_input_shapes(torch, "resnet50", BATCH, SIZE)
    elems = sum(n * c * h * w for n, c, h, w in shapes)
    check(len(shapes) == 53, f"R-50 at {SIZE}^2 batch {BATCH}: {len(shapes)} BatchNorm inputs, "
          f"{elems / 1e9:.3f} G elements")
    # every BN input of the step at once; each kernel and its library call
    # timed in turns over whole sweeps of the 53 inputs, medians of REPEATS
    # sweeps. The library calls only time the same function: the port
    # never calls them.
    data = []
    nbytes = {"moments": 0, "pair": 0, "apply": 0, "dx": 0}
    for n, c, h, w in shapes:
        x = (torch.randn(n, h, w, c, generator=gen, device=dev) + 0.3).bfloat16()
        g = torch.randn(n, h, w, c, generator=gen, device=dev).bfloat16()
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels-last NCHW
        ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        run = (torch.zeros(c, device=dev), torch.ones(c, device=dev),
               torch.tensor(0, device=dev))
        mean, _, rstd, mul = mo.bn_stats_cuda(x, ones, *run, eps, keep)
        _, _, a, b = mo.bn_grad_cuda(g, x, mean, rstd)
        lm, linv = torch.batch_norm_stats(xc, eps)
        sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(gc, xc, lm, linv, ones,
                                                           True, True, True)
        count = torch.tensor([n * h * w], dtype=torch.int32, device=dev)
        data.append(dict(x=x, g=g, xc=xc, gc=gc, ones=ones, zeros=zeros, run=run,
                         mean=mean, rstd=rstd, mul=mul, a=a, b=b, lm=lm, linv=linv,
                         sdy=sdy, sdyx=sdyx, count=count))
        e = n * h * w * c
        # each input read once and each output written once; float32 [C]
        # vectors: stats reads gamma and the running pair, writes 6 + 2;
        # pair reads mean and rstd, writes 5; apply reads 3; dx reads 4
        nbytes["moments"] += 2 * e + 11 * 4 * c
        nbytes["pair"] += 4 * e + 7 * 4 * c
        nbytes["apply"] += 4 * e + 3 * 4 * c
        nbytes["dx"] += 6 * e + 4 * 4 * c
    ops = {"moments": 3 * elems, "pair": 3 * elems, "apply": 3 * elems, "dx": 5 * elems}

    def sweep(fn):
        return lambda: [fn(d) for d in data]

    pairs = {
        "moments": (lambda d: mo.bn_stats_cuda(d["x"], d["ones"], *d["run"], eps, keep),
                    lambda d: torch.batch_norm_stats(d["xc"], eps),
                    lambda d: mo.bn_stats_plain(d["x"], d["ones"], *d["run"], eps, keep),
                    "torch.batch_norm_stats"),
        "pair": (lambda d: mo.bn_grad_cuda(d["g"], d["x"], d["mean"], d["rstd"]),
                 lambda d: torch.batch_norm_backward_reduce(
                     d["gc"], d["xc"], d["lm"], d["linv"], d["ones"], True, True, True),
                 lambda d: mo.bn_grad_plain(d["g"], d["x"], d["mean"], d["rstd"]),
                 "torch.batch_norm_backward_reduce"),
        "apply": (lambda d: mo.bn_apply_cuda(d["x"], d["mean"], d["mul"], d["zeros"]),
                  lambda d: torch.batch_norm_elemt(d["xc"], d["ones"], d["zeros"], d["lm"],
                                                   d["linv"], eps),
                  lambda d: mo.bn_apply_plain(d["x"], d["mean"], d["mul"], d["zeros"]),
                  "torch.batch_norm_elemt"),
        "dx": (lambda d: mo.bn_dx_cuda(d["g"], d["x"], d["mean"], d["mul"], d["a"], d["b"]),
               lambda d: torch.batch_norm_backward_elemt(
                   d["gc"], d["xc"], d["lm"], d["linv"], d["ones"], d["sdy"], d["sdyx"],
                   d["count"]),
               lambda d: mo.bn_dx_plain(d["g"], d["x"], d["mean"], d["mul"], d["a"], d["b"]),
               "torch.batch_norm_backward_elemt"),
    }
    label = {"moments": "stats (sums + finishing) kernel", "pair": "pair (sums + finishing) kernel",
             "apply": "apply kernel", "dx": "dx kernel"}
    rows = {}
    for key, (kern, lib, plain, lib_name) in pairs.items():
        (tk, sk), (tl, sl) = paired_ms(torch, sweep(kern), sweep(lib), 3)
        tp, _ = cuda_ms(torch, sweep(plain), 1)
        bd, bby = bound(nbytes[key], ops[key], F32_FLOP_S)
        rows[key] = dict(max_abs_err=worst[key], ms=tk, plain_ms=tp, bound_ms=bd,
                         bound_by=bby, library_ms=tl)
        say(f"   {label[key]} over the 53 BN inputs of one step (bf16): {tk:.3f} ms "
            f"(spread {sk:.1%}), {lib_name} {tl:.3f} ms ({sl:.1%}) in turns, median of "
            f"{REPEATS} sweeps; plain {tp:.3f} ms; bound {bd:.3f} ms ({bby}, "
            f"{nbytes[key] / 1e9:.2f} GB, {nbytes[key] / elems:.2f} B/elem at "
            f"{HBM_BYTES_S / 1e12:.2f} TB/s): {bd / tk:.1%} of the bound")
    # the sums kernels' device time from the profiler, by kernel, and the
    # host's time to enqueue a sweep: the event-timed sweep is the larger
    # of the two where the host cannot keep the device fed
    for key in ("moments", "pair"):
        split = kernel_split(torch, sweep(pairs[key][0]), 3)
        dev_ms = sum(split.values())
        host = host_ms(torch, sweep(pairs[key][0]))
        rows[key]["device_ms"] = dev_ms
        say(f"   {label[key]}, device time (profiler) over the 53 inputs: {dev_ms:.3f} ms, "
            f"{rows[key]['bound_ms'] / dev_ms:.1%} of the bound ("
            + ", ".join(f"{short_name(n)} {ms:.3f} ms" for n, ms in sorted(split.items()))
            + f"); event-timed sweep {rows[key]['ms']:.3f} ms; the host's enqueue time "
            f"{host:.3f} ms, {1e3 * host / len(data):.1f} us a call")
    # the whole layer, forward and backward, in turns with cuDNN's
    # F.batch_norm: (1) per input, with a wait after each input's loop (the
    # PR 2-3 measure; on the small layers it times the host's dispatch and
    # one autograd engine call per layer); (2) as a step runs its layers:
    # the 53 forwards, then one backward over all of them, the gradients
    # returned by autograd.grad (not added into .grad)
    layers = []
    for d in data:
        c = d["x"].shape[-1]
        layers.append((BatchNorm2d(c).to(dev).train(), d["xc"].detach().requires_grad_(True),
                       torch.zeros(c, device=dev), torch.ones(c, device=dev),
                       torch.ones(c, device=dev, requires_grad=True),
                       torch.zeros(c, device=dev, requires_grad=True), d["gc"]))
    del data
    bk = bl = 0.0
    for bn, xr, rm, rv, wr, br, gc in layers:
        (t_bk, _), (t_bl, _) = paired_ms(
            torch, lambda: bn(xr).backward(gc), lambda: F.batch_norm(
                xr, rm, rv, wr, br, training=True, momentum=0.1, eps=1e-5).backward(gc), 2)
        bk += t_bk
        bl += t_bl

    grads = [gc for *_, gc in layers]
    port_inputs = [t for bn, xr, *_ in layers for t in (xr, bn.weight, bn.bias)]
    cudnn_inputs = [t for _, xr, _, _, wr, br, _ in layers for t in (xr, wr, br)]

    def port_sweep():
        torch.autograd.grad([bn(xr) for bn, xr, *_ in layers], port_inputs, grads)

    def cudnn_sweep():
        torch.autograd.grad([F.batch_norm(xr, rm, rv, wr, br, training=True, momentum=0.1,
                                          eps=1e-5) for _, xr, rm, rv, wr, br, _ in layers],
                            cudnn_inputs, grads)

    (sk, sk_s), (sl, sl_s) = paired_ms(torch, port_sweep, cudnn_sweep, 2)
    # what bounds those sweeps: their kernel time (profiler) and the host's
    # time to enqueue them
    dk = sum(kernel_split(torch, port_sweep, 2).values())
    dl = sum(kernel_split(torch, cudnn_sweep, 2).values())
    hk, hl = host_ms(torch, port_sweep), host_ms(torch, cudnn_sweep)
    del layers, grads, port_inputs, cudnn_inputs
    whole_bound = sum(nbytes.values()) / HBM_BYTES_S * 1e3
    say(f"   whole BatchNorm forward + backward over the 53 inputs, bound of the four kernels "
        f"{whole_bound:.3f} ms:")
    say(f"     as a step runs them, 53 forwards then one backward (median of {REPEATS}): port "
        f"module {sk:.3f} ms ({sk_s:.1%}), cuDNN F.batch_norm {sl:.3f} ms ({sl_s:.1%}): the "
        f"port is {'faster' if sk < sl else 'slower'} by {abs(sk / sl - 1):.1%}; their kernels "
        f"(profiler): port {dk:.3f} ms, cuDNN {dl:.3f} ms; the host's time to enqueue them: "
        f"port {hk:.3f} ms ({1e3 * hk / len(shapes):.0f} us a layer), cuDNN {hl:.3f} ms")
    say(f"     per input with a wait after each: port module {bk:.3f} ms, cuDNN F.batch_norm "
        f"{bl:.3f} ms: the port is {'faster' if bk < bl else 'slower'} by {abs(bk / bl - 1):.1%}")
    return rows


def phase_train(torch, dev, card, out_dir):
    """The training path through the port's CLI, its launch counts and one
    profiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from s2anet_tpu_torch.train import __main__ as train_cli
    from s2anet_tpu_torch.train.step import train_step

    say("== 9. training path")
    warm, steps = 3, 5
    args = ["--backbone", "resnet50", "--img-size", str(SIZE), "--batch-size", str(BATCH),
            "--dtype", "bfloat16", "--clamp", "6.0", "--warmup", str(warm),
            "--steps", str(steps), "--seed", str(SEED)]
    say(f"   python -m s2anet_tpu_torch.train {' '.join(args)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    for k in train_cli.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    summary = train_cli.main(args)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in train_cli.KERNELS}
    n = warm + steps
    per = {k: v / n for k, v in launches.items()}
    say(f"   {n} steps in {time.perf_counter() - t0:.1f} s (model build and cuDNN "
        f"autotuning included): {summary['ms_per_step']:.2f} ms/step, "
        f"{summary['img_per_s']:.2f} img/s, peak memory {summary['peak_memory_gib']:.2f} GiB")
    check(all(abs(v) < 1e6 for v in summary["losses"]) and all(
        v == v for v in summary["losses"]), f"finite losses {summary['losses']}")
    check(per["s2a_deform_conv2d_fwd"] == 5 and per["s2a_deform_conv2d_bwd"] == 5
          and per["s2a_channel_moments"] == 53 and per["s2a_grad_channel_sums"] == 53
          and per["s2a_bn_apply"] == 53 and per["s2a_bn_dx"] == 53
          and per["s2a_box_iou_rotated"] == 2 and per["s2a_nms_rotated_mask"] == 0
          and per["s2a_bn_apply_finish"] == 0 and per["s2a_bn_dx_finish"] == 0,
          f"launches per step {per} (one process: no fused finishing kernel, no collective)")

    cfg, model, optimizer, ema, batches = train_cli.setup(train_cli.parse_opt(args))
    for i in range(2):
        train_step(model, optimizer, ema, batches[i % len(batches)], cfg).tolist()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(model, optimizer, ema, batches[0], cfg).tolist()
    avg = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    (out_dir / "chip_smoke_train_profile.txt").write_text(
        f"{card}\n{avg.table(sort_by=key, row_limit=80)}\n")
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                   and getattr(e, key) > 0), key=lambda e: -getattr(e, key))
    busy = sum(getattr(e, key) for e in kern) / 1000
    groups: dict = {}
    for e in kern:
        name = e.key
        grp = ("AlignConv forward kernel" if "deform_fwd" in name else
               "AlignConv backward kernel" if "deform_bwd" in name
               else "BN sums and finishing kernels (moments, pair)" if "channel_sums" in name
               else "BN apply kernel" if "bn_apply" in name
               else "BN dx kernel" if "bn_dx" in name
               else "rotated IoU kernel" if "box_iou_rotated" in name
               else "optimizer and EMA (foreach)" if "multi_tensor" in name
               else "convolutions (cuDNN)" if any(
                   t in name for t in ("conv", "xmma", "gemm", "cutlass", "sm90", "wgrad", "dgrad"))
               else "memcpy, memset" if "Memcpy" in name or "Memset" in name
               else "elementwise, reductions, gather")
        groups[grp] = groups.get(grp, 0.0) + getattr(e, key) / 1000
    wall = summary["ms_per_step"]
    say(f"   profile of one step: {busy:.2f} ms of kernels in {sum(e.count for e in kern)} "
        f"launches; timed step wall {wall:.2f} ms -> device idle share "
        f"{max(0.0, 1 - busy / wall):.3f}")
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        say(f"     {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {grp}")
    say("   top kernels:")
    for e in kern[:14]:
        say(f"     {getattr(e, key) / 1000:9.3f} ms  {e.count:5d}x  {e.key[:100]}")
    del model, optimizer, ema, batches, prof
    torch.cuda.empty_cache()
    return launches, summary, batches_first_gt(train_cli, args)


def batches_first_gt(train_cli, args):
    """The gt rows ``[B, 64, 5]`` of the training run's first batch."""
    opt = train_cli.parse_opt(args)
    b = train_cli.synthetic_batches(1, opt.batch_size, opt.img_size, opt.seed)[0]
    return b["gt_boxes"]


def phase_step_vs_plain(torch, dev):
    """One R-18 train step through the kernels and through the plain
    versions (section 10 of the module docstring)."""
    from s2anet_tpu_torch.models import assigner as as_mod
    from s2anet_tpu_torch.models import bn as bn_mod
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.models.head import compute_s2anet_loss
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import iou_rotated as iou
    from s2anet_tpu_torch.ops import moments as mo
    from s2anet_tpu_torch.train import __main__ as train_cli

    say("== 10. one train step: kernel path vs plain path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    args = ["--backbone", "resnet18", "--img-size", "256", "--batch-size", "2",
            "--dtype", "float32", "--synthetic", "1", "--seed", str(SEED)]
    plain_bwd = (mock.patch.object(dc, "deform_conv2d_bwd_cuda", dc.deform_conv2d_bwd_plain),
                 mock.patch.object(bn_mod, "bn_grad", mo.bn_grad_plain),
                 mock.patch.object(bn_mod, "bn_dx", mo.bn_dx_plain))
    plain_fwd = (mock.patch.object(head_mod, "deform_conv2d", dc.deform_conv2d_plain),
                 mock.patch.object(bn_mod, "bn_stats", mo.bn_stats_plain),
                 mock.patch.object(bn_mod, "bn_apply", mo.bn_apply_plain),
                 mock.patch.object(as_mod, "box_iou_rotated", iou.box_iou_rotated_plain))

    def forward(patches, perturb=0.0):
        cfg, model, _, _, batches = train_cli.setup(train_cli.parse_opt(args))
        bt = batches[0]
        imgs = bt["imgs"]
        if perturb:
            noise = torch.randn(imgs.shape, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(1))
            imgs = imgs * (1 + perturb * noise)
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            out = model(imgs)
            total, items = compute_s2anet_loss(
                out, bt["gt_boxes"], bt["gt_classes"], bt["gt_mask"],
                imgs_size=tuple(imgs.shape[-2:]), num_classes=cfg.num_classes)
        return model, total, items.detach()

    def backward(model, total, patches, retain=False):
        model.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            total.backward(retain_graph=retain)
        return {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    for k in train_cli.KERNELS:
        k.launches = 0
    m_k, total_k, items_k = forward(())
    g_kk = backward(m_k, total_k, (), retain=True)
    g_kp = backward(m_k, total_k, plain_bwd)
    kernel_launches = {k.symbol: k.launches for k in train_cli.KERNELS}
    for k in train_cli.KERNELS:
        k.launches = 0
    m_p, total_p, items_p = forward(plain_fwd)
    g_pp = backward(m_p, total_p, plain_bwd)
    plain_launches = sum(k.launches for k in train_cli.KERNELS)
    m_q, total_q, _ = forward(plain_fwd, perturb=1e-7)
    g_qq = backward(m_q, total_q, plain_bwd)

    def rel_max(a, b):
        return {k: ((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30)).item()
                for k in b}

    def rel_global(a, b):
        num = sum(((a[k] - b[k]) ** 2).sum() for k in b) ** 0.5
        return (num / sum((b[k] ** 2).sum() for k in b) ** 0.5).item()

    item_rel = ((items_k - items_p).abs() / items_p.abs()).max().item()
    check(item_rel <= 1e-4, f"loss items kernel {[round(v, 6) for v in items_k.tolist()]} "
          f"vs plain {[round(v, 6) for v in items_p.tolist()]}: max relative "
          f"difference {item_rel:.3g} (bound 1e-4)")
    bwd = rel_max(g_kk, g_kp)
    worst_name = max(bwd, key=bwd.get)
    check(max(bwd.values()) <= 1e-3 and kernel_launches["s2a_deform_conv2d_bwd"] == 5
          and kernel_launches["s2a_grad_channel_sums"] == 20
          and kernel_launches["s2a_bn_dx"] == 20 and kernel_launches["s2a_bn_apply"] == 20,
          f"same forward, backward kernels vs plain backward: every one of {len(bwd)} "
          f"gradients within {max(bwd.values()):.3g} of its largest value (worst "
          f"{worst_name}; bound 1e-3); launches {kernel_launches}")
    check(plain_launches == 0, "the plain path launched no kernel")
    full, floor = rel_max(g_kk, g_pp), rel_max(g_qq, g_pp)
    say(f"   all-kernel vs all-plain path: per-gradient max difference up to "
        f"{max(full.values()):.3g} of its largest value (median "
        f"{sorted(full.values())[len(full) // 2]:.3g}), {rel_global(g_kk, g_pp):.3g} of the "
        f"global norm; the plain path itself under a 1e-7 relative input perturbation: up "
        f"to {max(floor.values()):.3g} (median {sorted(floor.values())[len(floor) // 2]:.3g}), "
        f"{rel_global(g_qq, g_pp):.3g} of the global norm (train-mode BN on 2 images "
        f"amplifies rounding: ReLU and max-pool flips)")
    torch.backends.cudnn.deterministic = False
    return item_rel, max(bwd.values())


def draw_objects(rng, img, n: int, margin: int = 80):
    """``n`` filled rotated rectangles drawn on ``img`` (RGB), all inside
    the frame; returns their boxes ``[n, 5]`` (x, y, w, h, theta) and
    classes."""
    h, w = img.shape[:2]
    boxes = np.stack([rng.uniform(margin, w - margin, n), rng.uniform(margin, h - margin, n),
                      rng.uniform(24, 120, n), rng.uniform(10, 40, n),
                      rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1)
    for cx, cy, bw, bh, a in boxes:
        r = int(np.ceil(0.5 * np.hypot(bw, bh)))
        x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, w)
        y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, h)
        yy, xx = np.mgrid[y0:y1, x0:x1] + 0.5
        u = (xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)
        v = -(xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)
        img[y0:y1, x0:x1][(np.abs(u) <= bw / 2) & (np.abs(v) <= bh / 2)] = rng.integers(140, 256, 3)
    return boxes, rng.integers(0, 15, n)


def write_eval_data(root: Path, rng, n_chips: int, scene_hw):
    """A DOTA-format chip set in the JAX package's layout (``images/*.png``
    with BGR ``.npy`` sidecars written after them, ``labels/*.txt`` YOLO
    rotated) and one RGB ``.npy`` scene with its DOTA ``labelTxt``."""
    from s2anet_tpu_torch.config import DOTA10_CLASSES
    from s2anet_tpu_torch.data.synth import write_png
    from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np

    (root / "chips" / "images").mkdir(parents=True)
    (root / "chips" / "labels").mkdir()
    for i in range(n_chips):
        img = rng.integers(0, 90, (SIZE, SIZE, 3), dtype=np.uint8)
        boxes, classes = draw_objects(rng, img, 12)
        png = root / "chips" / "images" / f"chip_{i:04d}.png"
        write_png(png, img)
        np.save(png.with_suffix(".npy"), img[:, :, ::-1])  # BGR, newer than the PNG
        polys = rbox_vertices_np(boxes).reshape(-1, 8) / SIZE
        (root / "chips" / "labels" / f"chip_{i:04d}.txt").write_text("".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p) + "\n" for c, p in zip(classes, polys)))
    (root / "scene").mkdir()
    (root / "scene_gt").mkdir()
    scene = rng.integers(0, 90, scene_hw + (3,), dtype=np.uint8)
    boxes, classes = draw_objects(rng, scene, 200)
    np.save(root / "scene" / "scene_0000.npy", scene)
    polys = rbox_vertices_np(boxes).reshape(-1, 8)
    (root / "scene_gt" / "scene_0000.txt").write_text("".join(
        " ".join(f"{v:.1f}" for v in p) + f" {DOTA10_CLASSES[c]} 0\n"
        for c, p in zip(classes, polys)))
    return scene


@contextlib.contextmanager
def plain_path(head_mod, dc, nms):
    """The model with the plain AlignConv and the plain NMS keep."""
    with mock.patch.object(head_mod, "deform_conv2d", dc.deform_conv2d_plain), \
            mock.patch.object(nms, "nms_keep", nms.nms_keep_plain):
        yield


def dets_array(dets):
    """``[(class, score, poly[8])]`` -> (``[n, 6]`` centre x, y, 0, 0, 0,
    score; ``[n]`` classes) for :func:`match_1to1`."""
    a = np.zeros((len(dets), 6))
    for i, (_, s, p) in enumerate(dets):
        a[i, :2] = np.asarray(p).reshape(4, 2).mean(0)
        a[i, 5] = s
    return a, np.array([c for c, _, _ in dets], np.int64)


def labelled_cfg(cfg, gt_dir: Path):
    """``cfg`` scoring in merge mode against the labelTxt files in ``gt_dir``."""
    import dataclasses

    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, val_gt_dir=str(gt_dir)),
        eval=dataclasses.replace(cfg.eval, is_map_split=False))


def labelled_aps(chip_dets, scfg) -> list:
    """AP50 of each class that has labels, ``chip_dets`` scored by ``scfg``."""
    from s2anet_tpu_torch.eval.runner import score_detections

    r = score_detections(chip_dets, scfg)
    return [c["ap"] for c in r["per_class"].values() if c["npos"]]


def matched_by_class(da, db) -> int:
    """1:1 matches (label, score, centre within 1 px) of two detection
    lists, class by class."""
    (a, la), (b, lb) = dets_array(da), dets_array(db)
    return sum(match_1to1(a[la == c], la[la == c], b[lb == c], lb[lb == c])
               for c in np.unique(np.concatenate([la, lb])))


def relabel(out_dir: Path, chip_dets, names, per_class: int):
    """DOTA labelTxt files of the detections above each class's score cut,
    the ``per_class``-th best score of that class over all chips: every
    class gets labels, and a detection path scores against them."""
    by_class = {}
    for chip, dets in chip_dets.items():
        for c, s, p in dets:
            by_class.setdefault(c, []).append(s)
    cut = {c: np.sort(v)[::-1][min(per_class, len(v)) - 1] for c, v in by_class.items()}
    out_dir.mkdir(parents=True)
    n = 0
    for chip, dets in chip_dets.items():
        lines = [" ".join(repr(float(v)) for v in p) + f" {names[c]} 0\n"
                 for c, s, p in dets if s >= cut[c]]
        n += len(lines)
        (out_dir / f"{chip}.txt").write_text("".join(lines))
    return n, min(cut.values()), max(cut.values())


def rate_spread(rates) -> str:
    """Median, slowest and fastest of a few rates, in images/s."""
    r = sorted(rates)
    return (f"median {r[len(r) // 2]:.2f} images/s (runs " + ", ".join(f"{v:.2f}" for v in rates)
            + f"; spread {(r[-1] - r[0]) / r[len(r) // 2]:.1%})")


def loop_split(out) -> str:
    """The host's seconds of one evaluation loop (``evaluate_on_chips``)."""
    sec = out["seconds"]
    return (f"loop {sec['loop']:.3f} s, of it the host waiting for the loader "
            f"{sec['loader_wait']:.3f} s, for the device {sec['device_wait']:.3f} s, "
            f"post-processing {sec['post']:.3f} s")


def phase_eval(torch, dev, out_dir, keep: bool = False):
    """The evaluation path (section 11 of the module docstring); returns the
    val run's launches of the kernels on its path, the data's directory
    (deleted unless ``keep``) and the images/s of the val run over the
    listed chips."""
    from s2anet_tpu_torch import native
    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.config import DOTA10_CLASSES, Config, DataConfig, EvalConfig, ModelConfig
    from s2anet_tpu_torch.data.dota import BatchLoader, DotaDataset
    from s2anet_tpu_torch.data.split import window_origins
    from s2anet_tpu_torch.eval.runner import evaluate_on_chips
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import nms_rotated as nms

    say("== 11. evaluation")
    root = out_dir / "eval"
    shutil.rmtree(root, ignore_errors=True)
    n_chips, scene_hw, gap = 16, (3000, 4000), 200
    t0 = time.perf_counter()
    scene = write_eval_data(root, np.random.default_rng(SEED), n_chips, scene_hw)
    say(f"   wrote {n_chips} {SIZE}x{SIZE} PNG chips (zlib) with BGR .npy sidecars and YOLO "
        f"labels, and a {scene_hw[0]}x{scene_hw[1]} RGB .npy scene with its DOTA labelTxt, "
        f"in {time.perf_counter() - t0:.1f} s; native polygon library: "
        f"{'built' if native.AVAILABLE else 'absent (no host compiler): NumPy loops'}")
    images = root / "chips" / "images"

    kernels = [dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = ["--data-root", str(images), "--batch-size", str(BATCH), "--conf-thres", "0.005",
            "--seed", str(SEED), "--save-dir", str(root / "val")]
    # the chips listed LISTED times: 64 batches, a loop of seconds in the
    # steady state of the one-batch-deep pipeline
    listed = root / "chips" / f"val_x{LISTED}.txt"
    listed.write_text("".join(f"{q}\n" for _ in range(LISTED)
                              for q in sorted(images.glob("*.png"))))
    say(f"   python -m s2anet_tpu_torch.val {' '.join(args)}, then with --data-root "
        f"{listed.name} (the {n_chips} chips {LISTED} times)")
    runs = []
    for run, data_root in enumerate((images, listed)):
        args[1] = str(data_root)
        nb = -(-n_chips * (LISTED if data_root == listed else 1) // BATCH)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = port_val.main(args)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in kernels}
        runs.append((out, time.perf_counter() - t0))
        check(launches == {"s2a_deform_conv2d_fwd": 5 * nb, "s2a_nms_rotated_mask": nb,
                           "s2a_nms_rotated_sweep": nb},
              f"val run {run + 1}: launches {launches} over {nb} batches (AlignConv 5 a "
              f"batch, NMS mask and sweep 1 a batch)")
        if run == 0:
            res, first_launches = out, launches
    m = (res["map50"], res["mp"], res["mr"])
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m),
          f"map50 {m[0]:.4f}, precision {m[1]:.4f}, recall {m[2]:.4f}: finite, in [0, 1] "
          f"(random weights against drawn objects)")
    seen = {line.split()[0] for f in (root / "val" / "chip_results").glob("Task1_*.txt")
            for line in f.read_text().splitlines()}
    n_det = sum(len(d) for d in res["chip_dets"].values())
    check(res["n_images"] == n_chips and seen == {p.stem for p in images.glob("*.png")},
          f"every chip has its entry: {res['n_images']} images, {len(seen)} in the "
          f"Task1 files, {n_det} detections")
    for name, (out, wall) in zip((f"{n_chips} chips", f"{n_chips * LISTED} listed"), runs):
        say(f"   val {name}: {out['images_per_sec']:.2f} images/s end to end "
            f"({out['n_images']} images; {loop_split(out)}; {wall:.1f} s with model build "
            f"and mAP)")

    # the loader alone (no model), and the runner's pipeline (pinned ring,
    # outputs fetched one batch late) against a plain synchronous step
    # (pageable input copy, outputs fetched as each batch ends): each over
    # the listed chips, in turns
    ds = DotaDataset(listed, img_size=SIZE)
    loader = {1: [], 4: []}
    for _ in range(TURNS):
        for workers in loader:
            t0 = time.perf_counter()
            n = sum(len(b["paths"]) for b in BatchLoader(ds, BATCH, num_workers=workers))
            loader[workers].append(n / (time.perf_counter() - t0))
    say(f"   the loader alone over {len(ds)} listed chips (BGR sidecars, no model), "
        f"{TURNS} runs in turns: " + "; ".join(
            f"{w} worker{'s' * (w > 1)} {rate_spread(r)}" for w, r in loader.items()))
    pred = port_predict.S2ANetPredictor(ModelConfig(score_thr=0.005), device="cuda", seed=SEED)
    pred.predict(np.zeros((BATCH, SIZE, SIZE, 3), np.uint8))

    def synchronous(imgs):
        return tuple(t.cpu() for t in pred.predict(imgs))

    lcfg = Config(model=pred.cfg, data=DataConfig(root=str(listed), img_size=SIZE),
                  eval=EvalConfig(batch_size=BATCH))
    steps = {"pinned ring": pred, "synchronous": synchronous}
    ab = {name: [] for name in steps}
    for _ in range(TURNS):
        for name, step in steps.items():
            ab[name].append(evaluate_on_chips(step, lcfg, dataset=ds))
    say(f"   evaluate_on_chips over {len(ds)} listed chips, {TURNS} runs each in turns:")
    for name, outs in ab.items():
        say(f"     {name}: {rate_spread([o['images_per_sec'] for o in outs])}; of its median "
            f"run: {loop_split(sorted(outs, key=lambda o: o['images_per_sec'])[TURNS // 2])}")
    del pred

    args = ["--source", str(root / "scene"), "--npy", "--batch-size", str(BATCH), "--conf", "0.005",
            "--gap", str(gap), "--seed", str(SEED), "--save-dir", str(root / "predict")]
    say(f"   python -m s2anet_tpu_torch.predict {' '.join(args)}")
    summary = port_predict.main(args)
    windows = window_origins(*scene_hw, SIZE, SIZE - gap)
    check(summary["chips"] == len(windows) == 20,
          f"scene {scene_hw[0]}x{scene_hw[1]}: {summary['chips']} windows at gap {gap} "
          f"(window_origins: {len(windows)})")
    polys = np.array([[float(v) for v in line.split()[2:]] for line in
                      (root / "predict" / "scene_0000.txt").read_text().splitlines()])
    side = np.sqrt(((polys[:, 2:4] - polys[:, 0:2]) ** 2).sum(1) + (
        (polys[:, 4:6] - polys[:, 2:4]) ** 2).sum(1))
    xs, ys = polys[:, 0::2], polys[:, 1::2]
    inside = ((xs >= -side[:, None]) & (xs <= scene_hw[1] + side[:, None])
              & (ys >= -side[:, None]) & (ys <= scene_hw[0] + side[:, None])).all(1)
    check(len(polys) > 0 and inside.all(),
          f"{len(polys)} merged detections, all in the scene's frame (+- the box size)")
    say(f"   scene: {summary['seconds']:.3f} s: model {summary['model_seconds']:.3f} s, "
        f"merge {summary['merge_seconds']:.3f} s (bf16, score_thr 0.005, "
        f"{summary['detections']} detections after the merge)")

    # float32, TF32 off: the kernel path against the plain path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    mcfg = ModelConfig(score_thr=0.005)
    pred32 = port_predict.S2ANetPredictor(mcfg, device="cuda", dtype=torch.float32, seed=SEED)

    def run_scene():
        return next(port_predict.serve_chips(pred32, [("scene_0000", scene)], SIZE, gap,
                                             BATCH, mcfg.nms_iou_thr))[2]

    dk = run_scene()
    with plain_path(head_mod, dc, nms):
        dp = run_scene()
    frac = matched_by_class(dk, dp) / max(len(dk), len(dp), 1)
    check(frac >= 0.95, f"scene, float32: kernel vs plain path merged detections matched 1:1 "
          f"by (label, score, centre within 1 px) {frac:.4f} ({len(dk)} and {len(dp)})")

    # under the metric: each path once over the chips, then scored in merge
    # mode against labels made from a plain path's own detections
    cfg = Config(model=mcfg, data=DataConfig(root=str(images), img_size=SIZE),
                 eval=EvalConfig(batch_size=BATCH))
    dets = {}
    with plain_path(head_mod, dc, nms):
        dets["plain f32"] = evaluate_on_chips(pred32, cfg)["chip_dets"]
    dets["kernel f32"] = evaluate_on_chips(pred32, cfg)["chip_dets"]
    del pred32
    pred16 = port_predict.S2ANetPredictor(mcfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    with plain_path(head_mod, dc, nms):
        dets["plain bf16"] = evaluate_on_chips(pred16, cfg)["chip_dets"]
    dets["kernel bf16"] = evaluate_on_chips(pred16, cfg)["chip_dets"]
    del pred16
    torch.cuda.empty_cache()
    scores = {}
    for src in ("plain f32", "plain bf16"):
        scfg = labelled_cfg(cfg, root / ("labels_" + src.replace(" ", "_")))
        n_gt, lo, hi = relabel(Path(scfg.data.val_gt_dir), dets[src], DOTA10_CLASSES,
                               GT_PER_CLASS)
        for path in dets:
            labelled = labelled_aps(dets[path], scfg)
            scores[src, path] = float(np.mean(labelled))
        say(f"   labels from the {src} path: {n_gt} (each class's {GT_PER_CLASS} best, score "
            f"cuts {lo:.5f}-{hi:.5f}, {len(labelled)} classes have detections); mAP50 over "
            f"those classes, merge mode: " + ", ".join(
                f"{path} {scores[src, path]:.4f}" for path in dets))
    check(scores["plain f32", "plain f32"] >= 0.99 and scores["plain bf16", "plain bf16"] >= 0.99,
          f"each plain path against its own labels: {scores['plain f32', 'plain f32']:.4f}, "
          f"{scores['plain bf16', 'plain bf16']:.4f} (1.0 by construction)")
    check(scores["plain f32", "kernel f32"] >= 0.95,
          f"float32 kernel path against the float32 plain path's labels: "
          f"{scores['plain f32', 'kernel f32']:.4f} (bar 0.95)")
    check(scores["plain bf16", "kernel bf16"] >= 0.90,
          f"bf16 kernel path against the bf16 plain path's labels: "
          f"{scores['plain bf16', 'kernel bf16']:.4f} (bar 0.90)")

    # bf16 against float32 labels: the random-weight scores are near-ties
    # (all about sigmoid(bias) = 0.0101) that a flipped last bit anywhere in
    # the net reorders, so one model's gap between the bf16 paths is one
    # draw: +0.0076, -0.0019 and +0.0440 in three H100 runs of the same
    # weights, as what ran earlier in the process changed which bits flip
    # (permuting the AlignConv's input channels moved it by 0.001 at most).
    # One model's draw can also jump: seed 4 read 0.9452 / 0.8197 in one run
    # and 0.9512 / 0.9520 in another. So the gap is taken over MODELS random
    # models, each scored against its own float32 plain path's labels, and
    # their median is held within 0.02.
    t0 = time.perf_counter()
    gaps = {SEED: (scores["plain f32", "kernel bf16"], scores["plain f32", "plain bf16"])}
    for seed in range(SEED + 1, SEED + MODELS):
        models = {dtype: port_predict.S2ANetPredictor(mcfg, device="cuda", dtype=dtype,
                                                      seed=seed)
                  for dtype in (torch.float32, torch.bfloat16)}
        with plain_path(head_mod, dc, nms):
            ref, plain16 = (evaluate_on_chips(models[dtype], cfg)["chip_dets"]
                            for dtype in (torch.float32, torch.bfloat16))
        kernel16 = evaluate_on_chips(models[torch.bfloat16], cfg)["chip_dets"]
        del models
        scfg = labelled_cfg(cfg, root / f"labels_plain_f32_seed{seed}")
        relabel(Path(scfg.data.val_gt_dir), ref, DOTA10_CLASSES, GT_PER_CLASS)
        gaps[seed] = tuple(float(np.mean(labelled_aps(d, scfg))) for d in (kernel16, plain16))
    torch.cuda.empty_cache()
    d16 = [k - p for k, p in gaps.values()]
    median16 = float(np.median(d16))
    say(f"   bf16 against each model's float32 plain labels, kernel / plain path, seeds "
        f"{SEED}-{SEED + MODELS - 1} ({time.perf_counter() - t0:.1f} s for the "
        f"{MODELS - 1} more models): " + ", ".join(
            f"{k:.4f} / {p:.4f}" for k, p in gaps.values()))
    check(abs(median16) <= 0.02,
          f"against the float32 plain path's labels, bf16 scores by its dtype, not its "
          f"kernels: kernel - plain over {MODELS} models, median {median16:+.4f} (bar 0.02; "
          f"each model's " + ", ".join(f"{d:+.4f}" for d in d16) + ")")
    if not keep:
        shutil.rmtree(root)  # 100 MB of images: keep the --out directory small
    return first_launches, root, runs[1][0]["images_per_sec"]


INT8_OPS_S = 1979e12  # H100 SXM dense int8 tensor-core peak


def int8_conv_key(xq, wq, stride, pad, dtype, bias) -> tuple:
    """(B, H, W, Cin, Cout, k, stride, pad, output type, bias) of a call."""
    return tuple(xq.shape) + (wq.shape[0], wq.shape[1], stride, pad,
                              str(dtype).replace("torch.", ""), bias is not None)


def record_int8(pq, fn):
    """Run ``fn`` with the int8 wrappers of ``ops/quant.py`` recording each
    distinct conv and quantiser call: ``{key: [calls, first call's
    arguments]}`` for the convs and for the quantiser (the calls still run
    the kernels)."""
    convs, quants = {}, {}
    real_q, real_c = pq.quantize_act, pq.int8_conv2d

    def quantize(x, s, zp):
        e = quants.setdefault((tuple(x.shape), str(x.dtype).replace("torch.", "")), [0, None])
        e[0] += 1
        e[1] = e[1] or (x, s, zp)
        return real_q(x, s, zp)

    def conv(xq, wq, mul, corr, zp, stride, pad, dtype, bias=None):
        e = convs.setdefault(int8_conv_key(xq, wq, stride, pad, dtype, bias), [0, None])
        e[0] += 1
        e[1] = e[1] or (xq, wq, mul, corr, zp, stride, pad, dtype, bias)
        return real_c(xq, wq, mul, corr, zp, stride, pad, dtype, bias)

    with mock.patch.object(pq, "quantize_act", quantize), mock.patch.object(
            pq, "int8_conv2d", conv):
        fn()
    return convs, quants


def im2col_int8(torch, xq, k: int, stride: int, pad: int, zp: int):
    """``[B*Ho*Wo, k*k*Cin]`` int8 rows of the taps (ky, kx, ci) of each
    output position, padded with ``zp``: the A operand of ``torch._int_mm``
    for a k x k conv."""
    import torch.nn.functional as F

    b, h, w, c = xq.shape
    xp = F.pad(xq.permute(0, 3, 1, 2), (pad,) * 4, value=zp).permute(0, 2, 3, 1)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    cols = [xp[:, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    return torch.cat(cols, -1).reshape(b * ho * wo, k * k * c).contiguous()


PARENT_PKG = "s2anet_tpu_torch_parent"


def load_parent(parent: Path):
    """The port's package in an earlier checkout ``parent``, imported under
    another name, PARENT_PKG (its kernels build into its own ``build/``),
    for timing that tree beside this one in one process."""
    import importlib.util

    if PARENT_PKG in sys.modules:
        return sys.modules[PARENT_PKG]
    pkg = Path(parent) / "s2anet_tpu_torch"
    spec = importlib.util.spec_from_file_location(PARENT_PKG, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT_PKG] = mod
    spec.loader.exec_module(mod)
    return mod


def ptxas_summary(log: str, kernel: str) -> str:
    """Registers, spill bytes and shared memory of every instantiation of
    ``kernel`` in an ``nvcc -Xptxas -v`` log, in one line."""
    regs, spills, n, inside = set(), 0, 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            n += inside
        elif inside and "spill stores" in line:
            parts = line.replace(",", "").split()
            spills += int(parts[parts.index("spill") - 2]) + int(parts[-4])
        elif inside and "Used" in line:
            regs.add(int(line.split("Used")[1].split()[0]))
    if n == 0:
        return f"{kernel}: no ptxas output (library built earlier)"
    return (f"{kernel}: {n} instantiations, {'/'.join(map(str, sorted(regs)))} registers, "
            f"{spills} spill bytes (setmaxnreg: consumers 192, producer 120 at run time)")


def phase_quant(torch, dev, out_dir, root, bf16_listed_rate, parent=None):
    """int8 serving (section 13 of the module docstring) on phase 11's data
    in ``root``; ``parent``, a checkout of an earlier tree, adds its int8
    conv timed in turns. Returns the rows of the two kernels for the
    kernels line."""
    import importlib

    import torch.nn.functional as F

    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.config import ModelConfig
    from s2anet_tpu_torch.data.dota import DotaDataset
    from s2anet_tpu_torch.eval.runner import calibration_batches
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import quant as pq
    from s2anet_tpu_torch.ops.iou_rotated import box_iou_rotated_plain

    from s2anet_tpu_torch import _ext

    say("== 13. int8 serving")
    card = card_line()
    say(f"   card: {card}")
    say(f"   {ptxas_summary(_ext.build_log.get('int8_conv', (0, ''))[1], 'int8_conv_sm90')}")
    ppq = None
    if parent is not None:
        load_parent(parent)
        ppq = importlib.import_module(PARENT_PKG + ".ops.quant")
        ppq.CONV.build()
        say(f"   earlier tree for the in-turn timing: {parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    images = root / "chips" / "images"
    listed = root / "chips" / f"val_x{LISTED}.txt"
    calib = calibration_batches(DotaDataset(listed, img_size=SIZE), BATCH, 4)
    scopes = {"default": pq.QUANT_SCOPE_DEFAULT, "full": pq.QUANT_SCOPE_ALL}
    preds = {"bf16": port_predict.S2ANetPredictor(ModelConfig(), device="cuda", seed=SEED)}
    for name, scope in scopes.items():
        p = port_predict.S2ANetPredictor(ModelConfig(quant="int8", quant_scope=scope),
                                         device="cuda", seed=SEED)
        t0 = time.perf_counter()
        ranges = p.calibrate(calib)
        torch.cuda.synchronize()
        say(f"   int8 {name} scope {','.join(scope)}: R-50 1024^2 bf16, folded BN, calibrated "
            f"on 4 batches of 8 of phase 11's chips in {time.perf_counter() - t0:.2f} s "
            f"({len(ranges)} quantised convs)")
        preds[name] = p
    imgs = calib[0]
    x = preds["bf16"].to_input(imgs)
    kernels = (pq.QUANTIZE, pq.CONV)

    # launches a serving batch
    per_batch = {}
    for name in scopes:
        for k in kernels + (dc.DEFORM_FWD,):
            k.launches = 0
        preds[name].predict(imgs)
        torch.cuda.synchronize()
        per_batch[name] = {k.symbol: k.launches for k in kernels + (dc.DEFORM_FWD,)}
    check(per_batch["default"] == {"s2a_quantize_act": 100, "s2a_int8_conv2d": 100,
                                   "s2a_deform_conv2d_fwd": 5}
          and per_batch["full"] == {"s2a_quantize_act": 125, "s2a_int8_conv2d": 125,
                                    "s2a_deform_conv2d_fwd": 5},
          f"launches a serving batch: default scope {per_batch['default']}, full scope "
          f"{per_batch['full']} (52 backbone + 8 FPN + 40 stack convs; + 5 ORConv + 20 heads)")

    # every distinct quantised conv shape: kernel against plain, bit for bit
    counts = {}
    for name in scopes:  # the full scope's last: it calls every shape of the default one
        convs, quants = record_int8(pq, lambda: preds[name].forward(x))
        counts[name] = ({k: v[0] for k, v in convs.items()}, {k: v[0] for k, v in quants.items()})
    conv_err = q_err = 0.0
    n_equal = 0
    for key, (_, args) in quants.items():
        got = pq.quantize_act_cuda(*args)
        torch.cuda.synchronize()
        want = pq.quantize_act_plain(*args)
        q_err = max(q_err, (got.int() - want.int()).abs().max().item())
        n_equal += torch.equal(got, want)
    check(n_equal == len(quants), f"quantiser on the {len(quants)} distinct activation shapes "
          f"of a batch: kernel == plain bit for bit on {n_equal} (max |code difference| "
          f"{q_err})")
    n_equal = 0
    for key, (_, args) in convs.items():
        got = pq.int8_conv2d_cuda(*args)
        torch.cuda.synchronize()
        want = pq.int8_conv2d_plain(*args)
        conv_err = max(conv_err, (got.float() - want.float()).abs().max().item())
        n_equal += torch.equal(got, want)
    check(n_equal == len(convs), f"int8 conv on the {len(convs)} distinct shapes of both "
          f"scopes (1x1 and 3x3, stride 1 and 2, Cin 32-2048, Cout 5-2048, bf16 out): "
          f"kernel == plain bit for bit on {n_equal} (max |difference| {conv_err:.3g})")

    # times against the bound and the yardsticks, per distinct shape
    rows = []
    lines = [card, "int8 conv per distinct shape (B, H, W, Cin, Cout, k, stride, pad, out, "
             "bias): calls a batch default/full, kernel ms, bound ms (by), % of bound, "
             "plain ms, _int_mm ms (im2col prebuilt, not timed), cuDNN bf16 ms, earlier "
             "tree's kernel ms (in turns with this one; none without --parent), plan"]
    for key, (_, args) in sorted(convs.items()):
        xq, wq, _, _, zp, stride, pad, dtype, _ = args
        b, h, w, cin, cout, k = key[:6]
        ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        m, kk = b * ho * wo, k * k * cin
        t_par = None
        if ppq is not None:
            (t_k, _), (t_par, _) = paired_ms(torch, lambda a=args: pq.int8_conv2d_cuda(*a),
                                             lambda a=args: ppq.int8_conv2d_cuda(*a), 10)
        else:
            t_k, _ = cuda_ms(torch, lambda a=args: pq.int8_conv2d_cuda(*a), 10)
        t_p, _ = cuda_ms(torch, lambda a=args: pq.int8_conv2d_plain(*a), 1, repeats=1)
        out_b = 2 if dtype == torch.bfloat16 else 4
        bd = bound(xq.numel() + wq.numel() + m * cout * out_b + 12 * cout,
                   2.0 * m * cout * kk, INT8_OPS_S)
        t_mm = None
        if m > 16 and kk % 8 == 0 and cout % 8 == 0:
            a_mat = (xq.reshape(m, cin) if k == 1 and stride == 1 else
                     im2col_int8(torch, xq, k, stride, pad, int(zp.item())))
            b_mat = wq.reshape(cout, kk).t()
            t_mm, _ = cuda_ms(torch, lambda a=a_mat, bb=b_mat: torch._int_mm(a, bb), 10)
            del a_mat
        xc = torch.randn(b, cin, h, w, device=dev, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wc = torch.randn(cout, cin, k, k, device=dev, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        t_c, _ = cuda_ms(torch, lambda xc=xc, wc=wc, s=stride, p=pad: F.conv2d(
            xc, wc, stride=s, padding=p), 10)
        del xc, wc
        rows.append((key, t_k, bd, t_p, t_mm, t_c, t_par))
        plan = pq._plan(dev, xq.shape, wq.shape, stride, pad, dtype)[0]
        lines.append(f"{key}: {counts['default'][0].get(key, 0)}/{counts['full'][0][key]}, "
                     f"{t_k:.4f}, {bd[0]:.4f} ({bd[1]}), {bd[0] / t_k:.1%}, {t_p:.3f}, "
                     + (f"{t_mm:.4f}" if t_mm is not None else "none") + f", {t_c:.4f}, "
                     + (f"{t_par:.4f}" if t_par is not None else "none")
                     + f", bn {plan.bn} amode {plan.amode} kb {plan.kb} splits {plan.splits}")
    batch = {}
    for name in scopes:
        c = counts[name][0]
        sel = [(c.get(r[0], 0), r) for r in rows]
        batch[name] = dict(
            ms=sum(n * r[1] for n, r in sel), bound=sum(n * r[2][0] for n, r in sel),
            ops_bound=sum(n * r[2][0] for n, r in sel if r[2][1] == "operations"),
            plain=sum(n * r[3] for n, r in sel),
            int_mm=sum(n * r[4] for n, r in sel if r[4] is not None),
            int_mm_kernel=sum(n * r[1] for n, r in sel if r[4] is not None),
            cudnn=sum(n * r[5] for n, r in sel),
            parent=sum(n * r[6] for n, r in sel) if ppq is not None else None)
        bt = batch[name]
        say(f"   int8 conv, a batch, {name} scope ({sum(c.values())} calls, {len(c)} shapes): "
            f"kernel {bt['ms']:.3f} ms, bound {bt['bound']:.3f} ms ({bt['bound'] / bt['ms']:.1%}"
            f"; {bt['ops_bound']:.3f} ms of it from operations), plain {bt['plain']:.1f} ms; "
            f"yardsticks: cuDNN bf16 convs of the same shapes {bt['cudnn']:.3f} ms, "
            f"torch._int_mm {bt['int_mm']:.3f} ms where it applies (Cout % 8 == 0; the "
            f"kernel on those shapes {bt['int_mm_kernel']:.3f} ms; 3x3 as a prebuilt im2col, "
            f"its build not timed)" + (f"; the earlier tree's kernel in turns {bt['parent']:.3f} "
                                      f"ms ({bt['parent'] / bt['ms']:.2f}x)"
                                      if bt["parent"] is not None else ""))
        say(f"     against the aims: faster than torch._int_mm on its shapes: "
            f"{'met' if bt['int_mm_kernel'] < bt['int_mm'] else 'missed'}; at half of its bound "
            f"or better ({2 * bt['bound']:.3f} ms): "
            f"{'met' if bt['ms'] <= bt['bound'] * 2 else 'missed'}; "
            f"below cuDNN bf16: {'met' if bt['ms'] < bt['cudnn'] else 'missed'}")
    for key, t_k, bd, t_p, t_mm, t_c, t_par in sorted(
            rows, key=lambda r: -r[1] * counts["full"][0][r[0]])[:8]:
        say(f"     {key}: kernel {t_k:.4f} ms ({bd[0] / t_k:.1%} of {bd[0]:.4f}, {bd[1]}), "
            f"_int_mm " + (f"{t_mm:.4f}" if t_mm is not None else "none") + f", cuDNN bf16 "
            f"{t_c:.4f}" + (f", earlier tree {t_par:.4f} ({t_par / t_k:.2f}x)"
                            if t_par is not None else ""))
    if ppq is not None:
        for key in [(8, 128, 128, 256, 256, 3, 1, 1), (8, 32, 32, 2048, 256, 3, 2, 1)]:
            r = next(r for r in rows if r[0][:8] == key)
            say(f"     {key}: {r[6] / r[1]:.2f}x the earlier tree's kernel in turns (aim 2x: "
                f"{'met' if r[6] >= 2 * r[1] else 'missed'})")
    # the host's time to enqueue one quantised conv (the two wrappers), the
    # P5 stack conv's operands, on an idle card
    key = next(k for k in convs if k[:8] == (8, 32, 32, 256, 256, 3, 1, 1))
    cargs = convs[key][1]
    qargs = next(v[1] for k, v in quants.items() if k[0] == (8, 32, 32, 256))

    def enqueue(mod):
        return lambda: mod.int8_conv2d_cuda(mod.quantize_act_cuda(*qargs), *cargs[1:])
    enq = {"this tree": host_ms(torch, enqueue(pq), repeats=21) * 1e3}
    if ppq is not None:
        enq["earlier tree"] = host_ms(torch, enqueue(ppq), repeats=21) * 1e3
    say("   host enqueue of one quantised conv (quantiser + conv wrappers, P5 stack shape, "
        "median of 21 on an idle card): " + "; ".join(f"{k} {v:.1f} us" for k, v in enq.items()))
    q_rows = []
    for key, (_, args) in sorted(quants.items()):
        t_q, _ = cuda_ms(torch, lambda a=args: pq.quantize_act_cuda(*a), 10)
        t_qp, _ = cuda_ms(torch, lambda a=args: pq.quantize_act_plain(*a), 1, repeats=1)
        n = args[0].numel()
        bq = bound(n * (args[0].element_size() + 1), 0, INT8_OPS_S)
        q_rows.append((key, t_q, bq, t_qp))
        lines.append(f"quantise {key}: {counts['default'][1].get(key, 0)}/"
                     f"{counts['full'][1][key]}, {t_q:.4f} ms, bound {bq[0]:.4f}, "
                     f"{bq[0] / t_q:.1%}, plain {t_qp:.3f}")
        say(f"     {lines[-1]}")
    qbatch = {}
    for name in scopes:
        c = counts[name][1]
        qbatch[name] = tuple(sum(c.get(r[0], 0) * r[i] for r in q_rows) for i in (1, 3)) + (
            sum(c.get(r[0], 0) * r[2][0] for r in q_rows),)
        say(f"   quantiser, a batch, {name} scope ({sum(c.values())} calls): kernel "
            f"{qbatch[name][0]:.3f} ms, bound {qbatch[name][2]:.3f} ms (bytes: "
            f"{qbatch[name][2] / qbatch[name][0]:.1%}), plain {qbatch[name][1]:.3f} ms")
    (out_dir / "chip_smoke_int8.txt").write_text("\n".join(lines) + "\n")
    del convs, quants

    # the kernel path against the plain path at batch 2, and int8 against bf16
    x2 = x[:2]
    cfg = ModelConfig()
    for name in scopes:
        p = preds[name]
        p.forward(x2)  # cuDNN picks its algorithms for batch 2 first
        out_k = p.forward(x2)
        with _int8_plain(pq):
            out_p = p.forward(x2)
        diff = max((a.float() - b.float()).abs().max().item() for key in ("odm_cls", "odm_bbox")
                   for a, b in zip(out_k[key], out_p[key]))
        dk = [t.cpu().numpy() for t in head_dets(out_k, cfg)]
        dp = [t.cpu().numpy() for t in head_dets(out_p, cfg)]
        matched = total = 0
        for i in range(2):
            a, la = dk[0][i][dk[2][i]], dk[1][i][dk[2][i]]
            bb, lb = dp[0][i][dp[2][i]], dp[1][i][dp[2][i]]
            ious = box_iou_rotated_plain(torch.from_numpy(a[:, :5]), torch.from_numpy(bb[:, :5]))
            matched += match_1to1(a, la, bb, lb, ious.numpy())
            total += max(len(a), len(bb))
        check(total > 0 and matched >= 0.95 * total,
              f"int8 {name}, batch 2, score_thr 0.005: kernel path vs plain path (the int8 "
              f"convs and quantiser plain) matched 1:1 by IoU {matched / max(total, 1):.4f} of "
              f"{total}; head outputs max |kernel - plain| {diff:.3g}")
    # int8 against bf16. The JAX package's bar (tests/test_quant.py, R-18
    # 64^2) is 0.07 of max(|float|, 0.05). On R-50 its own int8 path moves
    # odm_bbox by up to 0.28 of that scale at 128^2, the port's by 0.39
    # (tests/test_torch_port_quant.py::test_int8_resnet50_moves_outputs_as_jax):
    # random-weight box deltas are tiny, and codes flipped early spread
    # through 60 quantised layers. So odm_cls keeps 0.07 and odm_bbox 0.5.
    out_b = preds["bf16"].forward(x)
    for name in scopes:
        out_q = preds[name].forward(x)
        errs = {}
        for key in ("odm_cls", "odm_bbox"):
            rel = [((a.float() - b.float()).abs() / max(a.float().abs().max().item(), 0.05))
                   for a, b in zip(out_b[key], out_q[key])]
            errs[key] = (max(r.max().item() for r in rel), max(r.mean().item() for r in rel))
        check(errs["odm_cls"][0] < 0.07 and errs["odm_bbox"][0] < 0.5,
              f"int8 {name} vs bf16, batch 8, in units of max(|bf16|, 0.05), largest / "
              f"largest per-level mean: odm_cls {errs['odm_cls'][0]:.4f} / "
              f"{errs['odm_cls'][1]:.5f} (bar 0.07), odm_bbox {errs['odm_bbox'][0]:.4f} / "
              f"{errs['odm_bbox'][1]:.5f} (bar 0.5)")
    del out_b, out_q, out_k, out_p

    # chips/s, each predictor in turns at both score thresholds
    rates = {(name, thr): [] for name in preds for thr in (cfg.score_thr, 0.005)}
    for p in preds.values():
        p.predict(imgs)[0].sum().item()
        p.predict(imgs, score_thr=0.005)[0].sum().item()
    for _ in range(3):
        for (name, thr), rs in rates.items():
            t0 = time.perf_counter()
            for _ in range(5):
                preds[name].predict(imgs, score_thr=thr)[0].sum().item()
            rs.append(5 * BATCH / (time.perf_counter() - t0))
    for thr in (cfg.score_thr, 0.005):
        say(f"   serving chips/s at batch {BATCH}, score_thr {thr} (3 runs of 5 batches each, "
            f"in turns): " + "; ".join(f"{name} {median_spread(rates[name, thr])[0]:.2f} "
                                        f"(runs {', '.join(f'{r:.2f}' for r in rates[name, thr])})"
                                        for name in preds))

    # one profiled batch of each: kernel time, launches, idle share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idle = {}
    for name in preds:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            preds[name].predict(imgs)[0].sum().item()
        avg = prof.key_averages()
        key = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
               else "self_cuda_time_total")
        kern = [e for e in avg if e.device_type == DeviceType.CUDA and getattr(e, key) > 0]
        busy = sum(getattr(e, key) for e in kern) / 1000
        int8 = sum(getattr(e, key) for e in kern if "int8_conv" in e.key) / 1000
        quant = sum(getattr(e, key) for e in kern if "quantize_act" in e.key) / 1000
        wall = 1000 * BATCH / median_spread(rates[name, cfg.score_thr])[0]
        idle[name] = max(0.0, 1 - busy / wall)
        say(f"   profile of one {name} batch: {busy:.2f} ms of kernels in "
            f"{sum(e.count for e in kern)} launches (int8 conv {int8:.2f} ms, quantiser "
            f"{quant:.2f} ms); timed batch wall {wall:.2f} ms -> device idle share "
            f"{idle[name]:.3f}")
    del preds
    torch.cuda.empty_cache()

    # python -m s2anet_tpu_torch.val --quant int8 on phase 11's chips
    gt_dir = root / "labels_plain_bf16"
    args = ["--data-root", str(images), "--batch-size", str(BATCH), "--conf-thres", "0.005",
            "--seed", str(SEED), "--quant", "int8", "--no-map-split", "--gt-dir", str(gt_dir)]
    say(f"   python -m s2anet_tpu_torch.val {' '.join(args)}")
    for k in kernels:
        k.launches = 0
    res = port_val.main(args)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    nb = -(-res["n_images"] // BATCH)
    check(launches == {"s2a_quantize_act": 100 * nb, "s2a_int8_conv2d": 100 * nb}
          and 0.0 <= res["map50"] <= 1.0,
          f"val --quant int8 on {res['n_images']} chips: launches {launches} ({nb} batches, "
          f"calibration in float); mAP50 {res['map50']:.4f} against the labels made from the "
          f"bf16 plain path's detections (merge mode; phase 11's bf16 kernel path scored "
          f">= 0.90 there)")
    args[1] = str(listed)
    args = args[:-3]  # chip-level mAP on the listed chips: the rate is the point
    lres = port_val.main(args)
    say(f"   val --quant int8 over {lres['n_images']} listed chips: "
        f"{lres['images_per_sec']:.2f} images/s end to end ({loop_split(lres)}); bf16 "
        f"(phase 11, same call): {bf16_listed_rate:.2f} images/s")

    src = "s2anet_tpu_torch/csrc/int8_conv.cu"
    bt, qt = batch["default"], qbatch["default"]
    return [
        dict(name="int8_conv2d", source=src, replaces="s2anet_tpu/ops/quant.py:151",
             launches=launches["s2a_int8_conv2d"], path="val --quant int8",
             max_abs_err=conv_err, ms=bt["ms"], plain_ms=bt["plain"], bound_ms=bt["bound"],
             bound_by="operations" if bt["ops_bound"] > bt["bound"] / 2 else "bytes",
             library_ms=None, int_mm_ms=bt["int_mm"], int_mm_kernel_ms=bt["int_mm_kernel"],
             cudnn_bf16_ms=bt["cudnn"], full_scope_ms=batch["full"]["ms"],
             full_scope_bound_ms=batch["full"]["bound"], idle_share=idle["default"],
             earlier_tree_ms=bt["parent"], host_enqueue_us=enq["this tree"]),
        dict(name="quantize_act", source=src, replaces="s2anet_tpu/ops/quant.py:166",
             launches=launches["s2a_quantize_act"], path="val --quant int8",
             max_abs_err=q_err, ms=qt[0], plain_ms=qt[1], bound_ms=qt[2], bound_by="bytes",
             library_ms=None, full_scope_ms=qbatch["full"][0]),
    ]


@contextlib.contextmanager
def _int8_plain(pq):
    """The int8 quantiser and conv through their plain versions."""
    with mock.patch.object(pq, "quantize_act", pq.quantize_act_plain), \
            mock.patch.object(pq, "int8_conv2d", pq.int8_conv2d_plain):
        yield


def head_dets(out, cfg):
    """Detections of head outputs at score_thr 0.005."""
    from s2anet_tpu_torch.models.head import decode_levels
    from s2anet_tpu_torch.ops import nms_rotated as nms

    boxes, scores = decode_levels(out, cfg.max_before_nms_per_level)
    return nms.multiclass_nms_rotated(boxes, scores, 0.005, cfg.nms_iou_thr, cfg.max_per_img,
                                      cfg.pre_nms_cap)



TRAIN_CHIPS, VAL_CHIPS = 32, 16  # phase 12: synthetic 1024^2 chips
STEADY_CHIPS = 128  # phase 12: the train chips of its 16-step epoch
RESUMES = 4  # phase 12: resumed runs of epoch 1


def phase_train_loop(torch, out_dir, step_ms):
    """The epoch loop (section 12 of the module docstring); ``step_ms`` is
    phase 9's ms/step, printed beside the loop's."""
    import csv
    import dataclasses

    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.config import load_config
    from s2anet_tpu_torch.data import image as image_mod
    from s2anet_tpu_torch.data import synth
    from s2anet_tpu_torch.data.dota import BatchLoader, DotaDataset
    from s2anet_tpu_torch.train import __main__ as train_cli
    from s2anet_tpu_torch.utils.callbacks import Callbacks

    say("== 12. training run")
    root = out_dir / "train_loop"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    synth.write_split(root / "train", TRAIN_CHIPS, rng, SIZE, 15, 3)
    synth.write_split(root / "val", VAL_CHIPS, rng, SIZE, 15, 3)
    say(f"   wrote {TRAIN_CHIPS} train and {VAL_CHIPS} val synthetic {SIZE}x{SIZE} chips "
        f"(s2anet_tpu_torch.data.synth, 15 classes) in {time.perf_counter() - t0:.1f} s")
    # configs/dota_r50.yaml, with a checkpoint every epoch for the resume check
    cfg = load_config(ROOT / "configs" / "dota_r50.yaml")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, save_period=1))
    cfg.save(root / "dota_r50_every_epoch.yaml")
    images = {k: str(root / k / "images") for k in ("train", "val")}
    args = ["--config", str(root / "dota_r50_every_epoch.yaml"), "--data-root",
            images["train"], "--val-root", images["val"], "--epochs", "2", "--batch-size",
            str(BATCH), "--seed", str(SEED)]
    say(f"   python -m s2anet_tpu_torch.train {' '.join(args)} --save-dir .../run "
        f"(configs/dota_r50.yaml with save_period 1)")

    kernels = train_cli.KERNELS
    counts = {"train": dict.fromkeys((k.symbol for k in kernels), 0), "val": None}
    counts["val"] = dict(counts["train"])
    mark = {}
    hooks = Callbacks()
    for kind, start, end in (("train", "on_train_batch_start", "on_train_batch_end"),
                             ("val", "on_val_start", "on_val_end")):
        def begin(kind=kind):
            mark[kind] = {k.symbol: k.launches for k in kernels}

        def finish(kind=kind):
            for k in kernels:
                counts[kind][k.symbol] += k.launches - mark[kind][k.symbol]
        hooks.register_action(start, callback=begin)
        hooks.register_action(end, callback=finish)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    summary = train_cli.main(args + ["--save-dir", str(root / "run")], callbacks=hooks)
    wall = time.perf_counter() - t0
    run = Path(summary["save_dir"])
    with open(run / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in r if k.startswith(("train/", "val/"))]
    check(len(rows) == 2 and all(np.isfinite(losses)) and len(losses) == 16
          and all(0.0 <= float(r["metrics/mAP_0.5"]) <= 1.0 for r in rows),
          f"2 results.csv rows, finite train and val losses, val mAP50 "
          f"{[float(r['metrics/mAP_0.5']) for r in rows]}")
    check(all((run / "weights" / n).is_file() for n in ("last", "best", "deploy", "epoch0")),
          "weights/last, best, deploy (and epoch0) written")
    shapes = {name: getattr(image_mod.imread(run / name), "shape", None)
              for name in PLOT_SIZES}
    check(shapes == {name: hw + (3,) for name, hw in PLOT_SIZES.items()},
          f"the training plots, read back by data/image.py: {shapes}")
    plot_s, mosaic_s = summary["plots_seconds"], summary["batch_plots_seconds"]
    steps = summary["steps"]
    per = {k: v / steps for k, v in counts["train"].items()}
    check(steps == 8 and per["s2a_deform_conv2d_fwd"] == 5 and per["s2a_deform_conv2d_bwd"] == 5
          and per["s2a_channel_moments"] == 53 and per["s2a_grad_channel_sums"] == 53
          and per["s2a_bn_apply"] == 53 and per["s2a_bn_dx"] == 53
          and per["s2a_box_iou_rotated"] == 2 and per["s2a_nms_rotated_mask"] == 0,
          f"{steps} train steps; launches per step {per} (as phase 9)")
    val_batches = 2 * -(-VAL_CHIPS // cfg.eval.batch_size)
    check(counts["val"] == {"s2a_deform_conv2d_fwd": 5 * val_batches,
                            "s2a_deform_conv2d_bwd": 0, "s2a_box_iou_rotated": 2 * val_batches,
                            "s2a_nms_rotated_mask": val_batches,
                            "s2a_nms_rotated_sweep": val_batches, "s2a_channel_moments": 0,
                            "s2a_grad_channel_sums": 0, "s2a_bn_apply": 0, "s2a_bn_dx": 0,
                            "s2a_bn_apply_finish": 0, "s2a_bn_dx_finish": 0},
          f"validation launches over {val_batches} batches {counts['val']}")
    epoch_ms = [1000 * float(r["time/epoch_s"]) / (steps // 2) for r in rows]
    say(f"   {wall:.1f} s in all; epoch loop {summary['ms_per_step']:.2f} ms/step over both "
        f"epochs, to the device's end (epoch 0 {epoch_ms[0]:.2f}, epoch 1 {epoch_ms[1]:.2f}), "
        f"the three mosaics' {mosaic_s:.3f} s of epoch 0 inside it; without them "
        f"{summary['ms_per_step'] - 1000 * mosaic_s / steps:.2f} ms/step; phase 9's "
        f"synthetic step {step_ms:.2f} ms/step in this run")
    say(f"   the plots' host seconds {plot_s:.3f} (labels, the three mosaics {mosaic_s:.3f}, "
        f"pr_curves, results); {card_line()}")
    say(f"   the host's wait for the loader: {summary['loader_wait_ms_per_step']:.3f} ms/step; "
        f"last validation {summary['val_seconds']:.2f} s ({VAL_CHIPS} chips, batch "
        f"{cfg.eval.batch_size}); peak memory {summary['peak_memory_gib']:.2f} GiB")
    say("   rows: " + "; ".join(
        f"epoch {r['epoch_or_step']}: " + ", ".join(
            f"{k} {float(v):.4g}" for k, v in r.items()
            if k.startswith(("train/", "val/", "metrics/mAP", "lr/"))) for r in rows))

    # the loader alone, augmented as the trainer loads (fliplr 0.5, rot90)
    d = cfg.data
    ds = DotaDataset(images["train"], img_size=d.img_size, max_gt=d.max_gt, augment=True,
                     fliplr=d.fliplr, flipud=d.flipud, rot90=d.degrees > 0)
    rates = []
    for epoch in range(3):
        loader = BatchLoader(ds, BATCH, shuffle=True, seed=SEED, drop_last=True)
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = sum(len(b["paths"]) for b in loader)
        rates.append(n / (time.perf_counter() - t0))
    say(f"   the loader alone, augmented, {loader.num_workers} threads: {rate_spread(rates)}")

    # the loop's steady state: one 16-step epoch (96 more chips beside the
    # 32), no validation, with 4 loader threads and with 1; per step the
    # host's time to enqueue it (from the batch-start to the batch-end hook)
    synth.write_split(root / "more", STEADY_CHIPS - TRAIN_CHIPS, rng, SIZE, 15, 3)
    listing = root / f"train_{STEADY_CHIPS}.txt"
    listing.write_text("".join(f"{q}\n" for d in ("train", "more")
                               for q in sorted((root / d / "images").glob("*.png"))))
    for workers in (4, 1):
        marks = {"on_train_batch_start": [], "on_train_batch_end": []}
        steady = Callbacks()
        for hook, ts in marks.items():
            steady.register_action(hook, callback=lambda ts=ts: ts.append(time.perf_counter()))
        s = train_cli.main(["--config", str(root / "dota_r50_every_epoch.yaml"), "--data-root",
                            str(listing), "--epochs", "1", "--noval", "--workers", str(workers),
                            "--batch-size", str(BATCH), "--seed", str(SEED), "--noplots",
                            "--save-dir", str(root / f"steady{workers}")], callbacks=steady)
        check(not any((root / f"steady{workers}" / name).exists() for name in PLOT_SIZES),
              f"--noplots: no plot in steady{workers}/")
        enqueue = np.subtract(marks["on_train_batch_end"], marks["on_train_batch_start"])
        say(f"   one {s['steps']}-step epoch, {workers} loader thread(s), no validation: "
            f"{s['ms_per_step']:.2f} ms/step to the device's end (phase 9: {step_ms:.2f}); "
            f"the host waits {s['loader_wait_ms_per_step']:.2f} ms a step for the loader and "
            f"enqueues a step in {1000 * np.median(enqueue):.2f} ms (median)")

    # resume from epoch 0's checkpoint into a new run dir: epoch 1 only. The
    # card's steps are not bit-equal (the AlignConv dx adds with atomics)
    # and random-weight training spreads that: the straight
    # runs' epoch-0 fam_reg_loss read 0.7013-0.7263 in three H100 runs of one
    # seed. So epoch 1 is resumed RESUMES times (the later ones without
    # validation), and the straight run's train losses are held within 5%
    # of the resumed runs' mean, plus 3 standard deviations of a run about it
    # (the resumed runs' spread x sqrt(1 + 1/RESUMES)).
    for k in kernels:
        k.launches = 0
    runs = [train_cli.main(args + ["--save-dir", str(root / f"resumed{i}"), "--resume",
                                   str(run / "weights" / "epoch0")]
                           + ["--noval", "--noplots"] * (i > 0))
            for i in range(RESUMES)]
    check(all((root / "resumed0" / f"train_batch{i}.png").is_file() for i in range(3))
          and not any((root / f"resumed{i}" / name).exists() for i in range(1, RESUMES)
                      for name in PLOT_SIZES),
          "the first resumed run draws train_batch0-2.png again; --noplots runs draw none")
    resumed, rrows = runs[0], []
    for r in runs:
        with open(Path(r["save_dir"]) / "results.csv", newline="") as f:
            rrows += list(csv.DictReader(f))
    check(resumed["steps"] == 4 and resumed["updates"] == summary["updates"] == 8
          and len(rrows) == RESUMES and rrows[0]["epoch_or_step"] == "1"
          and all(r["lr/0"] == rows[1]["lr/0"] for r in rrows),
          f"--resume weights/epoch0: {resumed['steps']} steps (epoch 1 only), "
          f"{resumed['updates']} updates, lr {[r['lr/0'] for r in rrows]} (straight run "
          f"{rows[1]['lr/0']}), {len(rrows)} resumed runs")
    gaps = {}
    for k in (k for k in rows[1] if k.startswith("train/")):
        r = np.array([float(row[k]) for row in rrows])
        spread = float(r.std(ddof=1) / r.mean())
        gaps[k] = (abs(float(rows[1][k]) / r.mean() - 1),
                   0.05 + 3 * spread * np.sqrt(1 + 1 / RESUMES), spread)
    check(all(rel <= bar for rel, bar, _ in gaps.values()),
          f"the straight run's epoch-1 train losses against the mean of the {RESUMES} "
          f"resumed runs: " + "; ".join(
              f"{k[6:]} {rel:.2%} (bar {bar:.2%}; the resumed runs' spread {spread:.2%})"
              for k, (rel, bar, spread) in gaps.items()))

    # the deploy weights through python -m s2anet_tpu_torch.val (folded BN,
    # bf16 cast) against the trainer's last validation (live BN, f32 master
    # weights computing in bf16)
    vargs = ["--config", str(ROOT / "configs" / "dota_r50.yaml"), "--weights",
             str(run / "weights" / "deploy"), "--data-root", images["val"]]
    say(f"   python -m s2anet_tpu_torch.val {' '.join(vargs)}")
    out = port_val.main(vargs)
    last = float(rows[-1]["metrics/mAP_0.5"])
    check(abs(out["map50"] - last) <= 0.02,
          f"val on the deploy weights mAP50 {out['map50']:.4f}, the trainer's last "
          f"validation {last:.4f}")
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return summary


# phase 12: the training plots and their (H, W): matplotlib's figsize x 120
# dpi; a mosaic of 8 chips is 3 x 3 tiles of 640^2; results.csv has 14
# columns besides epoch_or_step: 4 rows of 4 panels of 480 x 360
PLOT_SIZES = {"labels.png": (960, 1200), "train_batch0.png": (1920, 1920),
              "train_batch1.png": (1920, 1920), "train_batch2.png": (1920, 1920),
              "pr_curves.png": (720, 960), "results.png": (1440, 1920)}


# phase 14: rect serving of the HRSC2016 configuration
HRSC_CONFIG = ROOT / "configs" / "hrsc_r50.yaml"
# (h, w) of the synthetic HRSC-like images, 4 each: landscape, square and
# portrait, as HRSC2016's (its images are about 1000 x 600 to 1100 x 900)
HRSC_SHAPES = [(600, 1000), (512, 800), (700, 1000), (800, 800), (1000, 700), (1100, 900)]
HRSC_LISTED = 8  # phase 14: the images listed this many times for the timed runs


def hrsc_xml(name: str, hw, boxes, difficult) -> str:
    """An HRSC2016 ``Annotation`` file: each object's ``mbox_cx, cy, w, h,
    ang`` (the rotated box) and ``difficult``."""
    objs = "".join(
        f"<HRSC_Object><Object_ID>{i}</Object_ID><difficult>{int(d)}</difficult>"
        + "".join(f"<{k}>{v!r}</{k}>" for k, v in zip(
            ("mbox_cx", "mbox_cy", "mbox_w", "mbox_h", "mbox_ang"), map(float, b)))
        + "</HRSC_Object>" for i, (b, d) in enumerate(zip(boxes, difficult)))
    return (f"<HRSC_Image><Img_ID>{name}</Img_ID><Img_SizeHeight>{hw[0]}</Img_SizeHeight>"
            f"<Img_SizeWidth>{hw[1]}</Img_SizeWidth><HRSC_Objects>{objs}</HRSC_Objects>"
            f"</HRSC_Image>\n")


def write_hrsc_data(root: Path, rng):
    """24 images of HRSC2016's aspect ratios in the loader's layout
    (``images/*.png`` from the zlib writer with BGR ``.npy`` sidecars written
    after them, ``labels/*.txt`` YOLO rotated, 1 class) and an HRSC
    ``Annotation/*.xml`` per image; names in shuffled order, so rect
    batching reorders them. Returns ``{name: (h, w)}``."""
    from s2anet_tpu_torch.data.synth import write_png
    from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np

    for sub in ("images", "labels", "Annotation"):
        (root / sub).mkdir(parents=True)
    shapes = [hw for hw in HRSC_SHAPES for _ in range(4)]
    dims = {}
    for i, k in enumerate(rng.permutation(len(shapes))):
        h, w = shapes[k]
        name = f"1000{i:04d}"
        img = rng.integers(0, 90, (h, w, 3), dtype=np.uint8)
        boxes, _ = draw_objects(rng, img, 6)
        png = root / "images" / f"{name}.png"
        write_png(png, img)
        np.save(png.with_suffix(".npy"), img[:, :, ::-1])  # BGR, newer than the PNG
        polys = rbox_vertices_np(boxes).reshape(-1, 8) / np.tile([w, h], 4)
        (root / "labels" / f"{name}.txt").write_text("".join(
            "0 " + " ".join(f"{v:.6f}" for v in p) + "\n" for p in polys))
        (root / "Annotation" / f"{name}.xml").write_text(
            hrsc_xml(name, (h, w), boxes, rng.uniform(size=len(boxes)) < 0.15))
        dims[name] = (h, w)
    return dims


def detection_agreement(torch, dev, det_k, det_p):
    """``(centre, iou, total)``: the kernel path's detections ``det_k``
    against the plain path's ``det_p`` (NumPy ``(boxes, labels, valid)``),
    matched 1:1 by (label, score, centre within 1 px) and by (label, score,
    rotated IoU >= 0.5), as fractions of the larger count, image by image."""
    from s2anet_tpu_torch.ops import iou_rotated as iou

    centre = by_iou = total = 0
    for i in range(len(det_k[0])):
        a, la = det_k[0][i][det_k[2][i]], det_k[1][i][det_k[2][i]]
        bb, lb = det_p[0][i][det_p[2][i]], det_p[1][i][det_p[2][i]]
        ious = iou.box_iou_rotated_plain(torch.from_numpy(a[:, :5]).to(dev),
                                         torch.from_numpy(bb[:, :5]).to(dev))
        centre += match_1to1(a, la, bb, lb)
        by_iou += match_1to1(a, la, bb, lb, ious.cpu().numpy())
        total += max(len(a), len(bb))
    total = max(total, 1)
    return centre / total, by_iou / total, total


class TimedStep:
    """A predictor whose ``predict`` calls are timed on the host, with the
    shape of each batch (the evaluation runner's step)."""

    def __init__(self, pred):
        self.pred, self.device, self.calls = pred, pred.device, []

    def predict(self, imgs):
        t0 = time.perf_counter()
        out = self.pred.predict(imgs)
        self.calls.append((tuple(imgs.shape[1:3]), time.perf_counter() - t0))
        return out


def first_batch_split(out, calls, batch: int) -> str:
    """A run's rate beside its first batch's seconds, the seconds of the
    batches that met a new shape (cuDNN autotunes each on its first use),
    and the host's median time to enqueue one of the other batches."""
    seen, new_s, rest = set(), 0.0, []
    for shape, s in calls:
        if shape in seen:
            rest.append(s)
        else:
            seen.add(shape)
            new_s += s
    new_n = len(seen)
    loop = out["seconds"]["loop"]
    steady = (out["n_images"] - batch * new_n) / max(loop - new_s, 1e-9)
    return (f"{out['images_per_sec']:.2f} images/s; first batch {calls[0][1]:.3f} s, the "
            f"{new_n} batches at a new shape {new_s:.3f} s; without them {steady:.2f} "
            f"images/s, the host enqueueing one of them in "
            f"{1e3 * median_spread(rest)[0] if rest else float('nan'):.2f} ms (median)")


def phase_rect(torch, dev, out_dir):
    """Rect serving (section 14 of the module docstring); returns the
    launches of the kernels on its path: the ``val --rect`` run's, and a
    ``val --rect --quant int8`` batch's."""
    import dataclasses

    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.config import load_config
    from s2anet_tpu_torch.data.dota import BatchLoader, DotaDataset
    from s2anet_tpu_torch.eval.hrsc import evaluate_hrsc
    from s2anet_tpu_torch.eval.runner import evaluate_on_chips
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.models.detector import S2ANet
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import nms_rotated as nms
    from s2anet_tpu_torch.ops import quant as pq
    from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np
    from s2anet_tpu_torch.ops.rbox import poly_to_rbox_np
    from s2anet_tpu_torch.train.checkpoint import save_checkpoint
    from s2anet_tpu_torch.train.optim import Optimizer
    from s2anet_tpu_torch.train.state import ModelEMA

    say("== 14. rect serving (HRSC2016 configuration)")
    say(f"   card: {card_line()}")
    root = out_dir / "hrsc"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    dims = write_hrsc_data(root, np.random.default_rng(SEED + 14))
    images = root / "images"
    names = sorted(dims)
    say(f"   wrote {len(dims)} PNG images of shapes {sorted(set(dims.values()))} (zlib) with "
        f"BGR .npy sidecars, YOLO labels (1 class) and HRSC Annotation XML, in "
        f"{time.perf_counter() - t0:.1f} s")
    hcfg = load_config(HRSC_CONFIG, {"model": {"score_thr": 0.005},
                                     "eval": {"batch_size": BATCH, "rect": True}})
    size = hcfg.data.img_size
    plan = BatchLoader(DotaDataset(images, img_size=size), BATCH, rect=True)._batch_plan()
    nb = len(plan)
    targets = [t for _, t in plan]
    check(len(set(targets)) > 1 and all(h % 32 == 0 and w % 32 == 0 for h, w in targets)
          and sum(h * w for h, w in targets) < nb * size * size,
          f"rect plan at {size}, stride {hcfg.eval.rect_stride}: batch targets {targets}, "
          f"{sum(h * w for h, w in targets) / (nb * size * size):.3f} of the square batches' "
          f"pixels")

    # the rate with --rect against square batches, 3 runs each in turns,
    # before any other use of these shapes: the first batch at each shape
    # carries cuDNN's autotuning
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    listed = root / f"hrsc_x{HRSC_LISTED}.txt"
    listed.write_text("".join(f"{images / n}.png\n" for _ in range(HRSC_LISTED) for n in names))
    lds = DotaDataset(listed, img_size=size)
    pred16 = port_predict.S2ANetPredictor(hcfg.model, device="cuda", seed=SEED)
    runs = {"rect": [], "square": []}
    for _ in range(TURNS):
        for mode, rows in runs.items():
            step = TimedStep(pred16)
            cfg = dataclasses.replace(hcfg, eval=dataclasses.replace(
                hcfg.eval, rect=mode == "rect"))
            rows.append((evaluate_on_chips(step, cfg, dataset=lds), step.calls))
    say(f"   evaluate_on_chips over {len(lds)} listed images ({len(dims)} x {HRSC_LISTED}), "
        f"R-50 1 class bf16 batch {BATCH}, score_thr 0.005, {TURNS} runs each in turns:")
    for mode, rows in runs.items():
        say(f"     {mode}: {rate_spread([o['images_per_sec'] for o, _ in rows])}; shapes "
            f"{sorted({s for s, _ in rows[0][1]})}")
        for k, (o, calls) in enumerate(rows):
            say(f"       run {k + 1}: {first_batch_split(o, calls, BATCH)}; {loop_split(o)}")
    # a batch alone at each of those shapes (no loader, input on the card):
    # device time and the host's enqueue time
    say(f"   a batch of {BATCH} alone per shape (uint8 input on the card; CUDA events, median "
        f"of {REPEATS} loops of 3; host enqueue median of {REPEATS}):")
    for shape in sorted({s for s, _ in runs["rect"][0][1]} | {(size, size)}):
        xd = torch.randint(0, 256, (BATCH,) + shape + (3,), dtype=torch.uint8, device=dev)
        t_dev, sp = cuda_ms(torch, lambda xd=xd: pred16.predict(xd), 3)
        t_host = host_ms(torch, lambda xd=xd: pred16.predict(xd))
        say(f"     {shape}: {t_dev:.2f} ms a batch (spread {sp:.1%}; {1e3 * BATCH / t_dev:.1f} "
            f"images/s), enqueue {t_host:.2f} ms; {shape[0] * shape[1] / size ** 2:.3f} of "
            f"the square's pixels")

    # python -m s2anet_tpu_torch.val --config configs/hrsc_r50.yaml --rect
    kernels = [dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP]
    args = ["--config", str(HRSC_CONFIG), "--rect", "--data-root", str(images),
            "--batch-size", str(BATCH), "--conf-thres", "0.005", "--seed", str(SEED),
            "--save-dir", str(root / "val")]
    say(f"   python -m s2anet_tpu_torch.val {' '.join(args)}")
    seen = []
    real_predict = port_predict.S2ANetPredictor.predict

    def recorded(self, imgs, **kw):
        seen.append(tuple(imgs.shape[1:3]))
        return real_predict(self, imgs, **kw)

    for k in kernels:
        k.launches = 0
    with mock.patch.object(port_predict.S2ANetPredictor, "predict", recorded):
        res = port_val.main(args)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    check(seen == targets, f"val --rect batch shapes {seen} (the plan's)")
    check(launches == {"s2a_deform_conv2d_fwd": 5 * nb, "s2a_nms_rotated_mask": nb,
                       "s2a_nms_rotated_sweep": nb},
          f"val --rect: launches {launches} over {nb} batches (AlignConv 5 a batch, NMS mask "
          f"and sweep 1 a batch)")
    m = (res["map50"], res["mp"], res["mr"])
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m),
          f"map50 {m[0]:.4f}, precision {m[1]:.4f}, recall {m[2]:.4f}: finite, in [0, 1]")
    n_det = sum(len(d) for d in res["chip_dets"].values())
    check(res["n_images"] == len(dims) and sorted(res["chip_dets"]) == names,
          f"every image has its entry: {res['n_images']} images, {n_det} detections; "
          f"{res['images_per_sec']:.2f} images/s ({loop_split(res)})")
    hr = evaluate_hrsc([(img, s, p) for img, dets in res["chip_dets"].items()
                        for _, s, p in dets], root / "Annotation", names)
    check(np.isfinite(hr["ap"]) and 0.0 <= hr["ap"] <= 1.0,
          f"evaluate_hrsc of these detections against the written XML: AP {hr['ap']:.4f} "
          f"({hr['npos']} ships not difficult; random weights)")

    # per batch shape: the kernel path against the plain path, the
    # AlignConv forward at each level against its plain version, and the
    # NMS mask and keeps on the batch's candidates
    torch.backends.cudnn.benchmark = False
    batches = {}
    for batch in BatchLoader(DotaDataset(images, img_size=size), BATCH, rect=True):
        batches.setdefault(batch["imgs"].shape[1:3], batch["imgs"].copy())
    pred32 = port_predict.S2ANetPredictor(hcfg.model, device="cuda", dtype=torch.float32,
                                          seed=SEED)
    post = pred16.post_kwargs()
    dc_err = {}
    for shape, imgs in batches.items():
        for dtype, pred in ((torch.bfloat16, pred16), (torch.float32, pred32)):
            torch.backends.cudnn.allow_tf32 = dtype != torch.float32
            x = pred.to_input(imgs)
            taps = []
            real_dc = head_mod.deform_conv2d

            def tap(xl, ol, wl):
                taps.append((xl, ol, wl))
                return real_dc(xl, ol, wl)

            with mock.patch.object(head_mod, "deform_conv2d", tap):
                out_k = pred.forward(x)
            bk, sk = head_mod.decode_levels(out_k, post["max_before_nms_per_level"])
            det_k = [t.cpu().numpy() for t in head_mod.s2anet_get_bboxes(out_k, **post)]
            with plain_path(head_mod, dc, nms):
                det_p = [t.cpu().numpy() for t in pred.predict(imgs)]
            centre, by_iou, total = detection_agreement(torch, dev, det_k, det_p)
            name = str(dtype)[6:]
            if dtype == torch.float32:
                check(centre >= 0.95, f"{shape} float32: kernel vs plain path {total} "
                      f"detections matched 1:1 by centre {centre:.4f}, by IoU {by_iou:.4f}")
            else:
                check(by_iou >= 0.95, f"{shape} bfloat16: kernel vs plain path {total} "
                      f"detections matched 1:1 by IoU {by_iou:.4f}, by centre {centre:.4f}")
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
            for lv, (xl, ol, wl) in zip(LEVELS, taps):
                got = dc.deform_conv2d_cuda(xl, ol, wl)
                torch.cuda.synchronize()
                ref = dc.deform_conv2d_plain(xl, ol, wl)
                err = (got.float() - ref.float()).abs().max().item()
                dc_err[name] = max(dc_err.get(name, 0.0), err)
                check(torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol),
                      f"{shape} {name} AlignConv {lv} {tuple(xl.shape[1:3])} "
                      f"({xl.shape[0] * xl.shape[1] * xl.shape[2]} cells): max |kernel - "
                      f"plain| {err:.3g} (rtol = atol = {tol})")
            _, cb, cl, cv = nms.select_candidates(bk, sk, post["score_thr"],
                                                  post["pre_nms_cap"])
            diff, pairs = mask_bits_differing(torch, nms, cb, cl, cv, post["iou_thr"])
            keep_k = nms.nms_keep_cuda(cb, cl, cv, post["iou_thr"])
            torch.cuda.synchronize()
            keep_p = nms.nms_keep_plain(cb, cl, cv, post["iou_thr"])
            check(diff == 0 and torch.equal(keep_k, keep_p),
                  f"{shape} {name} NMS on the batch's candidates ({int(cv.sum())} valid): mask "
                  f"bits differing {diff} ({pairs} suppressing pairs), keeps identical "
                  f"({int(keep_k.sum())} kept)")
    del pred32
    torch.backends.cudnn.allow_tf32 = True

    # under the metric: HRSC XML labels from the bf16 plain path's own
    # detections (the GT_PER_CLASS best), every path scored against them
    dets = {}
    with plain_path(head_mod, dc, nms):
        dets["plain"] = evaluate_on_chips(pred16, hcfg, dataset=DotaDataset(
            images, img_size=size))["chip_dets"]
    dets["kernel"] = evaluate_on_chips(pred16, hcfg, dataset=DotaDataset(
        images, img_size=size))["chip_dets"]
    scores = sorted((s for d in dets["plain"].values() for _, s, _ in d), reverse=True)
    cut = scores[min(GT_PER_CLASS, len(scores)) - 1]
    gt_dir = root / "Annotation_plain"
    gt_dir.mkdir()
    for img, d in dets["plain"].items():
        polys = np.array([p for _, s, p in d if s >= cut]).reshape(-1, 8)
        (gt_dir / f"{img}.xml").write_text(hrsc_xml(
            img, dims[img], poly_to_rbox_np(polys) if len(polys) else [], [False] * len(polys)))
    ap = {path: evaluate_hrsc([(img, s, p) for img, d in dets[path].items() for _, s, p in d],
                              gt_dir, names)["ap"] for path in dets}
    check(ap["plain"] >= 0.99 and ap["kernel"] >= 0.90,
          f"evaluate_hrsc against XML from the bf16 plain path's {GT_PER_CLASS} best "
          f"detections (score cut {cut:.5f}): plain path AP {ap['plain']:.4f} (1.0 by "
          f"construction), kernel path {ap['kernel']:.4f} (bar 0.90, phase 11's bf16 bar)")
    del pred16

    # val --rect --quant int8: calibrated on square batches, then the int8
    # kernels at the rect shapes, each against its plain version
    for k in (pq.QUANTIZE, pq.CONV):
        k.launches = 0
    qres = {}
    convs, quants = record_int8(pq, lambda: qres.update(port_val.main(
        args + ["--quant", "int8", "--save-dir", str(root / "val_int8")])))
    torch.cuda.synchronize()
    q_launches = {k.symbol: k.launches for k in (pq.QUANTIZE, pq.CONV)}
    check(q_launches == {"s2a_quantize_act": 100 * nb, "s2a_int8_conv2d": 100 * nb}
          and qres["n_images"] == len(dims),
          f"val --rect --quant int8 (default scope): launches {q_launches} over {nb} batches "
          f"(100 each a batch, as at 1024^2); map50 {qres['map50']:.4f}, "
          f"{qres['images_per_sec']:.2f} images/s")
    n_q = sum(torch.equal(pq.quantize_act_cuda(*a), pq.quantize_act_plain(*a))
              for _, a in quants.values())
    n_c = sum(torch.equal(pq.int8_conv2d_cuda(*a), pq.int8_conv2d_plain(*a))
              for _, a in convs.values())
    torch.cuda.synchronize()
    check(n_q == len(quants) and n_c == len(convs),
          f"int8 at the rect shapes: quantiser kernel == plain bit for bit on {n_q} of "
          f"{len(quants)} activation shapes, int8 conv on {n_c} of {len(convs)} conv shapes")
    del convs, quants

    # a training checkpoint: EMA weights by default, the model's with --no-ema
    model = S2ANet(hcfg.model.backbone, hcfg.model.num_classes, tuple(hcfg.model.strides))
    model.init_weights(torch.Generator().manual_seed(SEED))
    ema = ModelEMA(model)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    last = root / "run" / "weights" / "last"
    save_checkpoint(last, model, ema, Optimizer(model, lambda _: 0.0), 0.0, 0)
    del model, ema
    ck = {}
    for name, extra in (("ema", []), ("model", ["--no-ema"])):
        ck[name] = port_val.main(args[:-1] + [str(root / f"val_{name}"), "--weights",
                                              str(last)] + extra)["chip_dets"]
    differ = sum([d[:2] for d in ck["ema"][n]] != [d[:2] for d in ck["model"][n]]
                 for n in names)
    check(len(ck["ema"]) == len(ck["model"]) == len(dims) and differ > 0,
          f"val --weights weights/last (train/checkpoint.py, EMA and model weights apart) "
          f"and with --no-ema: both load; detections differ on {differ} of {len(dims)} images")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {**launches, **q_launches, "batches": nb}


# phase 15: the Trainer's model and data options
OPTION_FLAGS = {  # the bench's flags for configs/dota_r50.yaml with one option changed
    "default": [],
    "frozen_stages 1": ["--frozen-stages", "1"],
    "norm_eval": ["--norm-eval"],
    "bn_stats_images 2": ["--bn-stats-images", "2"],
    "with_orconv false": ["--no-orconv"],
}
BN_SYMBOLS = ("s2a_channel_moments", "s2a_grad_channel_sums", "s2a_bn_apply", "s2a_bn_dx")
# BN launches a step (moments, pair, apply, dx) of R-50: 53 layers, 11 of
# them in the stem and layer1; sampled statistics run dx on two row ranges
OPTION_BN = {"default": (53, 53, 53, 53), "frozen_stages 1": (42, 42, 42, 42),
             "norm_eval": (0, 0, 0, 0), "bn_stats_images 2": (53, 53, 53, 106),
             "with_orconv false": (53, 53, 53, 53)}
OPTION_STEPS = 3  # timed train steps a configuration, each beside a plain step
OPTION_TRAIN, OPTION_VAL, OPTION_LISTED = 16, 8, 4  # 15c: chips, and the loader's listing


def phase_options(torch, dev, out_dir):
    """Section 15 of the module docstring; returns ``{configuration:
    launches a step}`` and the sampled-statistics kernels' rows."""
    import copy
    import csv
    import dataclasses
    import multiprocessing

    from s2anet_tpu_torch.config import load_config
    from s2anet_tpu_torch.data import synth
    from s2anet_tpu_torch.data.dota import BatchLoader, DotaDataset
    from s2anet_tpu_torch.models import assigner as as_mod
    from s2anet_tpu_torch.models import bn as bn_mod
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.models.head import compute_s2anet_loss
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import iou_rotated as iou
    from s2anet_tpu_torch.ops import moments as mo
    from s2anet_tpu_torch.train import __main__ as train_cli
    from s2anet_tpu_torch.train.step import train_step
    from s2anet_tpu_torch.utils.callbacks import Callbacks

    say("== 15. model and data options")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    plain = (mock.patch.object(head_mod, "deform_conv2d", dc.deform_conv2d_plain),
             mock.patch.object(dc, "deform_conv2d_bwd_cuda", dc.deform_conv2d_bwd_plain),
             mock.patch.object(as_mod, "box_iou_rotated", iou.box_iou_rotated_plain),
             *(mock.patch.object(bn_mod, n, getattr(mo, n + "_plain"))
               for n in ("bn_stats", "bn_apply", "bn_grad", "bn_dx")))
    base = ["--backbone", "resnet50", "--img-size", str(SIZE), "--batch-size", str(BATCH),
            "--clamp", "6.0", "--synthetic", "1", "--seed", str(SEED)]
    kernels = train_cli.KERNELS
    ms, per_step = {}, {}
    def recording(log):
        """Patches that log each assignment's anchors, IoUs and codes; the
        IoU function is the one in place when they are made."""
        iou_fn, assign_fn = as_mod.box_iou_rotated, head_mod.assign_labels

        def iou_logged(anchors, gt_boxes):
            out = iou_fn(anchors, gt_boxes)
            log.append({"anchors": anchors.detach(), "iou": out})
            return out

        def assign_logged(*args, **kw):
            log[-1]["codes"] = assign_fn(*args, **kw)
            return log[-1]["codes"]
        return (mock.patch.object(as_mod, "box_iou_rotated", iou_logged),
                mock.patch.object(head_mod, "assign_labels", assign_logged))

    def shared(a, b):
        """The largest difference of two paths' assignment inputs: the
        IoUs (absolute), the anchors (relative to 1 + |value|), and the
        anchors of the codes that differ."""
        iou = max((x["iou"] - y["iou"]).abs().nan_to_num(0.0).max().item()
                  for x, y in zip(a, b))
        anc = flipped = 0.0
        for x, y in zip(a, b):
            d = ((x["anchors"] - y["anchors"]).abs() / (1 + y["anchors"].abs())).amax(-1)
            d = d.expand(x["codes"].shape)
            anc = max(anc, d.max().item())
            differ = x["codes"] != y["codes"]
            if differ.any().item():
                flipped = max(flipped, d[differ].max().item())
        return iou, anc, flipped

    def steps(flags, dtype):
        """A warm-up and 3 timed train steps on the kernel path; before
        each, the plain path's forward, loss and backward on a copy of the
        model's current state. Returns the step walls; a step, the loss
        items' largest relative difference with the plain path's loss
        evaluated on the kernel path's assignment codes, the same with each
        path's own codes, the codes that differ and the largest difference
        of the assignment's inputs (IoUs, anchors); the launches a step,
        the BNs in inference mode and whether both paths kept their
        statistics."""
        cfg, model, optimizer, ema, batches = train_cli.setup(
            train_cli.parse_opt(base + ["--dtype", dtype] + flags))
        batch = batches[0]
        frozen = [m for m in model.modules()
                  if isinstance(m, torch.nn.BatchNorm2d) and not m.training]
        stats0 = [(m.running_mean.clone(), m.running_var.clone()) for m in frozen]

        def kept(net):
            bns = [m for m in net.modules()
                   if isinstance(m, torch.nn.BatchNorm2d) and not m.training]
            return len(bns) == len(stats0) and all(
                torch.equal(m.running_mean, a) and torch.equal(m.running_var, b)
                for m, (a, b) in zip(bns, stats0))

        def loss(out):
            return compute_s2anet_loss(
                out, batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"],
                imgs_size=(SIZE, SIZE), num_classes=cfg.num_classes, fl_gamma=cfg.fl_gamma,
                fl_alpha=cfg.fl_alpha, smooth_beta=cfg.smooth_beta,
                odm_balance=cfg.odm_balance, reg_balance=cfg.reg_balance,
                fpn_balance=tuple(cfg.fpn_balance))

        train_step(model, optimizer, ema, batch, cfg).tolist()  # warm-up: autotuning
        walls, ok = [], True
        rels = {"shared": [], "own": [], "codes": [], "iou": [], "anchors": [],
                "flipped": []}
        counts = dict.fromkeys((k.symbol for k in kernels), 0)
        for _ in range(OPTION_STEPS):
            twin = copy.deepcopy(model)
            log_p, log_k = [], []
            with contextlib.ExitStack() as stack:
                for p in plain:
                    stack.enter_context(p)
                for p in recording(log_p):
                    stack.enter_context(p)
                out = twin(batch["imgs"])
                total, items_p = loss(out)
                total.backward()
            ok &= kept(twin)
            out = {k: [t.detach() for t in v] for k, v in out.items()}
            del twin, total
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            with contextlib.ExitStack() as stack:
                for p in recording(log_k):
                    stack.enter_context(p)
                t0 = time.perf_counter()
                items_k = train_step(model, optimizer, ema, batch, cfg)
                items_k.tolist()
                walls.append(1000 * (time.perf_counter() - t0))
            for k in kernels:
                counts[k.symbol] += k.launches
            codes_k = iter([e["codes"] for e in log_k])
            with torch.no_grad(), mock.patch.object(
                    head_mod, "assign_labels", lambda *a, **kw: next(codes_k)):
                items_s = loss(out)[1]
            rels["shared"].append(((items_k - items_s).abs() / items_s.abs()).max().item())
            rels["own"].append(((items_k - items_p.detach()).abs()
                                / items_p.abs()).max().item())
            rels["codes"].append(sum((x["codes"] != y["codes"]).sum().item()
                                     for x, y in zip(log_k, log_p)))
            for key, v in zip(("iou", "anchors", "flipped"), shared(log_k, log_p)):
                rels[key].append(v)
            del out, log_p, log_k
        ok &= kept(model)
        per = {k: v / OPTION_STEPS for k, v in counts.items()}
        del model, optimizer, ema, batches, batch
        torch.cuda.empty_cache()
        return walls, rels, per, len(frozen), ok

    def fmt(rels):
        return ", ".join(f"{r:.3g}" for r in rels)

    # a. each configuration in bf16 (times, launches, the loss items' gap),
    # then in float32, TF32 off: the loss items within 1e-4 on one
    # assignment, whose IoUs agree within 1e-3, and the anchors of codes
    # that differ too (so a code differs only where its IoU or its anchor
    # lies within 1e-3 of one of the rule's thresholds)
    for name, flags in OPTION_FLAGS.items():
        torch.backends.cudnn.allow_tf32 = True
        walls, rels16, per, n_frozen, ok16 = steps(flags, "bfloat16")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        _, rels32, per32, _, ok32 = steps(flags, "float32")
        torch.backends.cudnn.deterministic = False
        ms[name] = float(np.median(walls))
        per_step[name] = per
        check(max(rels32["shared"]) <= 1e-4 and max(rels32["iou"]) <= 1e-3
              and max(rels32["flipped"]) <= 1e-3 and ok16 and ok32 and per32 == per
              and tuple(per[s] for s in BN_SYMBOLS) == OPTION_BN[name]
              and per["s2a_deform_conv2d_fwd"] == per["s2a_deform_conv2d_bwd"] == 5
              and per["s2a_box_iou_rotated"] == 2,
              f"{name}: loss items kernel path vs plain path from the same state, max "
              f"relative difference a step in float32 on the kernel path's assignment "
              f"{fmt(rels32['shared'])} (bound 1e-4), the assignment's IoUs within "
              f"{max(rels32['iou']):.3g} (bound 1e-3), codes differing "
              f"{fmt(rels32['codes'])} with their anchors within "
              f"{max(rels32['flipped']):.3g} (relative; bound 1e-3; all anchors "
              f"{max(rels32['anchors']):.3g}), each path "
              f"on its own codes {fmt(rels32['own'])}; bf16 (reported: bf16 rounding moves "
              f"anchors across the assignment's IoU thresholds) on one assignment "
              f"{fmt(rels16['shared'])}, on its own {fmt(rels16['own'])}, codes differing "
              f"{fmt(rels16['codes'])}; {n_frozen} BNs in inference mode, their "
              f"running statistics unchanged on both paths; launches a step (bf16 and "
              f"float32): BN moments / pair / apply / dx "
              f"{' / '.join(f'{per[s]:g}' for s in BN_SYMBOLS)}, AlignConv "
              f"{per['s2a_deform_conv2d_fwd']:g} + {per['s2a_deform_conv2d_bwd']:g}, IoU "
              f"{per['s2a_box_iou_rotated']:g}; {card}")
        say(f"   {name}: bf16 {ms[name]:.2f} ms/step (median of {OPTION_STEPS}: "
            f"{', '.join(f'{w:.2f}' for w in walls)}), default {ms['default']:.2f} ms/step "
            f"in this call; {card}")
    torch.backends.cudnn.allow_tf32 = True

    # b. the sampled-statistics kernels at the 53 R-50 BN shapes, prefix 2 of 8
    k_img = 2
    worst = {"moments": 0.0, "pair": 0.0, "apply": 0.0, "dx": 0.0}
    shapes = bn_input_shapes(torch, "resnet50", BATCH, SIZE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    eps, keep = 1e-5, 0.9
    for dtype in (torch.float32, torch.bfloat16):
        for n, c, h, w in shapes:
            x = (torch.rand(n, h, w, c, generator=gen, device=dev) * 2 + 0.3).to(dtype)
            g = torch.randn(n, h, w, c, generator=gen, device=dev).to(dtype)
            weight = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = torch.randn(c, generator=gen, device=dev) * 0.3
            run = (torch.zeros(c, device=dev), torch.ones(c, device=dev),
                   torch.tensor(0, device=dev))
            run_p = tuple(t.clone() for t in run)
            nk = k_img * h * w
            stats = mo.bn_stats_cuda(x[:k_img], weight, *run, eps, keep)
            mean, _, rstd, mul = stats
            grad = mo.bn_grad_cuda(g, x, mean, rstd, nk)
            sums = mo.channel_moments_cuda(x[:k_img]) + mo.grad_channel_sums_cuda(g, x)
            a, b = grad[2], grad[3]
            zero = torch.zeros_like(a)
            y = mo.bn_apply_cuda(x, mean, mul, bias)
            dx = torch.empty_like(x)
            mo.bn_dx_cuda(g[:k_img], x[:k_img], mean, mul, a, b, out=dx[:k_img])
            mo.bn_dx_cuda(g[k_img:], x[k_img:], mean, mul, zero, zero, out=dx[k_img:])
            torch.cuda.synchronize()
            ref = mo.stats_from_sums(sums[0], sums[1], nk, weight, *run_p, eps, keep)
            ref_g = mo.grad_from_sums(sums[2], sums[3], nk, mean, rstd)
            worst["moments"] = max([worst["moments"]] + [
                rel_to_max(u, v) for u, v in zip(stats + run[:2], ref + run_p[:2])])
            worst["pair"] = max([worst["pair"]] + [rel_to_max(u, v)
                                                   for u, v in zip(grad, ref_g)])
            worst["apply"] = max(worst["apply"], (y.float() - mo.bn_apply_plain(
                x, mean, mul, bias).float()).abs().max().item())
            want = torch.cat([mo.bn_dx_plain(g[:k_img], x[:k_img], mean, mul, a, b),
                              mo.bn_dx_plain(g[k_img:], x[k_img:], mean, mul, zero, zero)])
            worst["dx"] = max(worst["dx"], (dx.float() - want.float()).abs().max().item())
            del x, g, y, dx, want
    check(worst["moments"] <= 1e-6 and worst["pair"] <= 1e-6 and worst["apply"] == 0
          and worst["dx"] == 0,
          f"sampled statistics (prefix {k_img} of {BATCH}) at the {len(shapes)} R-50 BN "
          f"shapes, f32 and bf16: statistics and running statistics within "
          f"{worst['moments']:.3g}, pair finishing (count {k_img}*H*W) within "
          f"{worst['pair']:.3g} of the plain finishing on the kernel's sums (bound 1e-6); "
          f"apply and the two-range dx equal to the plain versions bit for bit; {card}")
    data = []
    for n, c, h, w in shapes:
        x = (torch.rand(n, h, w, c, generator=gen, device=dev) * 2 + 0.3).bfloat16()
        data.append((x, torch.ones(c, device=dev), torch.zeros(c, device=dev),
                     torch.ones(c, device=dev), torch.tensor(0, device=dev)))
    dev_ms = {}
    for label, rows in (("full batch", BATCH), (f"prefix {k_img}", k_img)):
        split = kernel_split(torch, lambda rows=rows: [
            mo.bn_stats_cuda(x[:rows], wt, rm, rv, tr, eps, keep)
            for x, wt, rm, rv, tr in data], 3)
        dev_ms[label] = sum(split.values())
    elems = sum(n * h * w * c for n, c, h, w in shapes)
    sbound = bound(2 * elems * k_img / BATCH, 3 * elems * k_img / BATCH, F32_FLOP_S)
    say(f"   stats kernel over the {len(shapes)} BN inputs of a step (bf16), device time "
        f"(profiler): full batch {dev_ms['full batch']:.3f} ms, prefix {k_img} of {BATCH} "
        f"{dev_ms[f'prefix {k_img}']:.3f} ms "
        f"({dev_ms[f'prefix {k_img}'] / dev_ms['full batch']:.2f}x; the prefix's bound "
        f"{sbound[0]:.3f} ms, {sbound[1]}); {card}")
    del data
    torch.cuda.empty_cache()

    # c. a short epoch with mosaic, the warp and the process loader, then
    # validation; and the augmented loader alone in both modes
    root = out_dir / "options"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 15)
    synth.write_split(root / "train", OPTION_TRAIN, rng, SIZE, 15, 3)
    synth.write_split(root / "val", OPTION_VAL, rng, SIZE, 15, 3)
    cfg = load_config(ROOT / "configs" / "dota_r50.yaml")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, mosaic=0.5, translate=0.1, scale=0.5, loader="process"))
    cfg.save(root / "dota_r50_mosaic.yaml")
    args = ["--config", str(root / "dota_r50_mosaic.yaml"), "--data-root",
            str(root / "train" / "images"), "--val-root", str(root / "val" / "images"),
            "--epochs", "1", "--batch-size", str(BATCH), "--seed", str(SEED),
            "--save-dir", str(root / "run")]
    say(f"   python -m s2anet_tpu_torch.train {' '.join(args)} (configs/dota_r50.yaml with "
        f"mosaic 0.5, translate 0.1, scale 0.5, loader process)")
    workers_seen = []
    hooks = Callbacks()
    hooks.register_action("on_train_batch_end", callback=lambda: workers_seen.append(
        len(multiprocessing.active_children())))
    for k in kernels:
        k.launches = 0
    summary = train_cli.main(args, callbacks=hooks)
    with open(Path(summary["save_dir"]) / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    losses = [float(v) for k, v in rows[0].items() if k.startswith(("train/", "val/"))]
    steps = summary["steps"]
    per = {k.symbol: k.launches for k in kernels}
    check(len(rows) == 1 and len(losses) == 8 and all(np.isfinite(losses))
          and 0.0 <= float(rows[0]["metrics/mAP_0.5"]) <= 1.0
          and steps == OPTION_TRAIN // BATCH and min(workers_seen) > 0
          and per["s2a_deform_conv2d_bwd"] == 5 * steps,
          f"one epoch of {steps} steps with mosaic, translate, scale and {min(workers_seen)} "
          f"loader processes, then validation: finite train and val losses, val mAP50 "
          f"{float(rows[0]['metrics/mAP_0.5']):.4f}; {summary['ms_per_step']:.2f} ms/step "
          f"to the device's end, the host waits {summary['loader_wait_ms_per_step']:.2f} ms "
          f"a step for the loader; {card}")
    listing = root / "train_listed.txt"
    listing.write_text("".join(f"{q}\n" for _ in range(OPTION_LISTED)
                               for q in sorted((root / "train" / "images").glob("*.png"))))
    d = cfg.data
    ds = DotaDataset(listing, img_size=SIZE, max_gt=d.max_gt, augment=True, fliplr=d.fliplr,
                     flipud=d.flipud, rot90=d.degrees > 0, mosaic=d.mosaic,
                     translate=d.translate, scale=d.scale)
    rates = {"process": [], "thread": []}
    for epoch in range(2):
        for mode in rates:
            loader = BatchLoader(ds, BATCH, shuffle=True, seed=SEED, drop_last=True,
                                 mode=mode)
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            n = sum(len(b["paths"]) for b in loader)
            rates[mode].append(n / (time.perf_counter() - t0))
            workers = loader.num_workers
            say(f"     epoch {epoch}, {mode} mode ({workers} workers): "
                f"{rates[mode][-1]:.2f} images/s")
    say(f"   the loader alone with mosaic 0.5, translate 0.1, scale 0.5 (and the recipe's "
        f"flips and rotations), {len(ds)} listed chips, 2 epochs each in turns: process "
        f"{rate_spread(rates['process'])}, thread {rate_spread(rates['thread'])}; {card}")
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return per_step, ms, worst, dev_ms


# phase 16: data-parallel training
DP_WORLD = 2
DP_STEPS = 2  # float32 steps held against one process
DP_WARMUP, DP_TIMED = 2, 5  # bf16 steps of the timing, before and timed
DP_TRAIN, DP_VAL = 16, 8  # 16b: synthetic chips (phase 12's generator and seed)
DP_BASE = ["--backbone", "resnet50", "--img-size", str(SIZE), "--batch-size", str(BATCH),
           "--clamp", "6.0", "--synthetic", "1", "--seed", str(SEED)]


def dp_patches(mods, log):
    """Patches that log each BN layer's forward mean and var (from the
    statistics ``fn`` of ``models.bn`` gives: ``bn_stats`` in one process,
    ``bn_apply_finish`` on a rank) and each assignment's codes; ``codes``,
    when given, replace the assignment's own (logged beside). On a rank each
    layer's input sums in float64 are logged too, computed apart from the
    kernels."""
    import torch

    bn_mod, head_mod, fn, codes = mods
    stats_fn, assign, sums = getattr(bn_mod, fn), head_mod.assign_labels, bn_mod.moment_sums
    on_rank = fn == "bn_apply_finish"

    def stats_logged(*args, **kw):
        out = stats_fn(*args, **kw)
        st = out[1] if on_rank else out
        log["stats"].append((st[0].detach().cpu(), st[1].detach().cpu()))
        return out

    def assign_logged(*args, **kw):
        own = assign(*args, **kw)
        log["codes"].append(own.cpu())
        return own if codes is None else codes[len(log["codes"]) - 1].to(own.device)

    def sums_logged(x):
        xd = x.double().reshape(-1, x.shape[-1])
        log["sums64"].append((torch.stack([xd.sum(0), (xd * xd).sum(0)]).cpu(), xd.shape[0]))
        return sums(x)
    patches = (mock.patch.object(bn_mod, fn, stats_logged),
               mock.patch.object(head_mod, "assign_labels", assign_logged))
    if on_rank:
        patches += (mock.patch.object(bn_mod, "moment_sums", sums_logged),)
    return patches


def dp_trees(train_cli, train_step, args, parent=None):
    """``{tree: (step, kernels)}``: a bf16 train step of this tree's port
    (the train CLI's setup on ``args``) and its kernels, and, given
    ``parent`` (an earlier checkout), the same of that tree's port."""
    import importlib

    trees = {"this tree": (train_cli, train_step)}
    if parent is not None:
        load_parent(Path(parent))
        trees["parent"] = (importlib.import_module(PARENT_PKG + ".train.__main__"),
                           importlib.import_module(PARENT_PKG + ".train.step").train_step)
    out = {}
    for name, (cli, step_fn) in trees.items():
        cfg, model, optimizer, ema, batches = cli.setup(cli.parse_opt(args))

        def step(step_fn=step_fn, state=(cfg, model, optimizer, ema, batches)):
            c, m, o, e, b = state
            step_fn(m, o, e, b[0], c).tolist()  # waits for the step
        out[name] = (step, cli.KERNELS)
    return out


def dp_timed(trees):
    """Warm-up steps of each tree, then DP_TIMED rounds of timed steps in
    turns (parent, this, this, parent; this tree alone without a parent):
    ``({tree: step walls in ms}, {tree: launches a step by symbol})``."""
    for step, _ in trees.values():
        for _ in range(DP_WARMUP):
            step()
    for _, kernels in trees.values():
        for k in kernels:
            k.launches = 0
    order = ("parent", "this tree", "this tree", "parent") if "parent" in trees else ("this tree",)
    walls = {name: [] for name in trees}
    for _ in range(DP_TIMED):
        for name in order:
            t0 = time.perf_counter()
            trees[name][0]()
            walls[name].append(1000 * (time.perf_counter() - t0))
    launches = {name: {k.symbol: k.launches / len(walls[name]) for k in kernels}
                for name, (_, kernels) in trees.items()}
    return walls, launches


def dp_profiled(torch, trees, profiled: bool):
    """With cuDNN's autotuning off (its choices are not the same from run to
    run), a warm-up step and a step of each tree; ``profiled``: the latter's
    device launches by name (profiler), ``{tree: {name: count}}``; else the
    steps alone (another rank's share of the same collectives)."""
    torch.backends.cudnn.benchmark = False
    out = {}
    for name, (step, _) in trees.items():
        step()
        if profiled:
            out[name] = launches_by_name(torch, step)
        else:
            step()
    torch.backends.cudnn.benchmark = True
    return out


def dp_rank(rank, store, work, device="cuda", base=None, parent=None):
    """One rank of phase 16a/c, started with the spawn start method: R-50
    1024^2, this rank's 4 of the global batch of 8. DP_STEPS float32 train
    steps (TF32 off, deterministic cuDNN), each logging its BN statistics,
    assignment codes and the gradient summed over the ranks (rank 0 also
    the state before the step), then bf16 steps timed on rank 0 with the
    kernels' launches. Given ``parent`` (an earlier checkout), that tree's
    port takes the same bf16 steps in turns with this one's, and rank 0
    profiles one step of each. ``device`` and ``base`` (the bench's flags)
    are the card and DP_BASE but in a rehearsal on the CPU."""
    import torch

    from s2anet_tpu_torch.models import bn as bn_mod
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.parallel import mesh
    from s2anet_tpu_torch.train import __main__ as train_cli
    from s2anet_tpu_torch.train.step import train_step

    work, base = Path(work), base or DP_BASE
    dev = mesh.init_group(device, f"file://{store}", rank, DP_WORLD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg, model, optimizer, ema, batches = train_cli.setup(train_cli.parse_opt(
        base + ["--dtype", "float32", "--device", str(dev)]))
    step = optimizer.step
    for s in range(DP_STEPS):
        log = {"stats": [], "codes": [], "sums64": []}
        if rank == 0:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       work / f"state{s}.pt")

        def logged_step():  # the gradient summed over the ranks, then the update
            log["grad"] = torch.cat([p.grad.reshape(-1) for p in optimizer.params]).cpu()
            step()
        optimizer.step = logged_step
        with contextlib.ExitStack() as stack:
            for patch in dp_patches((bn_mod, head_mod, "bn_apply_finish", None), log):
                stack.enter_context(patch)
            log["items"] = train_step(model, optimizer, ema, batches[0], cfg).cpu()
        torch.save(log if rank == 0 else {k: log[k] for k in ("codes", "sums64")},
                   work / f"step{s}.{rank}.pt")
    del model, optimizer, ema, batches
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True
    trees = dp_trees(train_cli, train_step, base + ["--dtype", "bfloat16", "--device", str(dev)],
                     parent)
    walls, launches = dp_timed(trees)
    profiled = (dp_profiled(torch, trees, rank == 0)
                if parent is not None and dev.type == "cuda" else {})
    (work / f"timing.{rank}.json").write_text(json.dumps({
        "walls": walls, "launches": launches, "profiled": profiled,
        "backend": mesh.dist.get_backend()}))
    mesh.shutdown()


def dp_world(torch, work, share: bool, device="cuda", base=None, parent=None):
    """Spawn the DP_WORLD ranks of ``dp_rank`` (``share``: all on the first
    card, over gloo; else one card each) and wait for them, 600 s at most."""
    import multiprocessing
    import os

    work.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")  # CUDA is up here: no fork
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    if share:
        os.environ["CUDA_VISIBLE_DEVICES"] = (saved or "0").split(",")[0]
    store = str((work / "store").resolve())  # a file:// URL takes an absolute path
    procs = [ctx.Process(target=dp_rank, args=(r, store, str(work), device, base,
                                               None if parent is None else str(parent)))
             for r in range(DP_WORLD)]
    for pr in procs:
        pr.start()
    if share:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    deadline = time.perf_counter() + 600
    for pr in procs:
        pr.join(max(0.0, deadline - time.perf_counter()))
    hung = [pr for pr in procs if pr.is_alive()]
    for pr in hung:
        pr.kill()
        pr.join()
    check(not hung and all(pr.exitcode == 0 for pr in procs),
          f"{DP_WORLD} ranks ran and exited 0 (exit codes {[pr.exitcode for pr in procs]}"
          f"{', killed after 600 s' if hung else ''})")


def dp_compare(torch, dev, work, label: str, base=None, layers: int = 53, parent=None):
    """The ranks' float32 steps against one process at batch 8 from the same
    state, on the ranks' assignment; then bf16 ms/step of one process beside
    the ranks' (with ``parent``, an earlier checkout: each tree's, in turns,
    and one profiled step of each tree, held name for name). Returns the
    ranks' launches a step (this tree, rank 0) and a dict of the times.
    ``base`` and ``layers`` (the BN layers) are DP_BASE's and R-50's but in
    a rehearsal on the CPU."""
    from s2anet_tpu_torch.models import bn as bn_mod
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.models.head import compute_s2anet_loss
    from s2anet_tpu_torch.train import __main__ as train_cli
    from s2anet_tpu_torch.train.step import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    base = base or DP_BASE
    cfg, model, optimizer, _, batches = train_cli.setup(train_cli.parse_opt(
        base + ["--dtype", "float32"]))
    batch = batches[0]

    def one_process(state, codes, log, scale=1.0):
        """Forward from ``state`` (the input times ``scale``), the loss on
        the ``codes``, backward: ``(loss items, the gradient, flat)``."""
        model.load_state_dict(state)
        with contextlib.ExitStack() as stack:
            for patch in dp_patches((bn_mod, head_mod, "bn_stats", codes), log):
                stack.enter_context(patch)
            total, items = compute_s2anet_loss(
                model(batch["imgs"] * scale), batch["gt_boxes"], batch["gt_classes"],
                batch["gt_mask"], imgs_size=(SIZE, SIZE), num_classes=cfg.num_classes,
                fl_gamma=cfg.fl_gamma, fl_alpha=cfg.fl_alpha, smooth_beta=cfg.smooth_beta,
                odm_balance=cfg.odm_balance, reg_balance=cfg.reg_balance,
                fpn_balance=tuple(cfg.fpn_balance))
        optimizer.zero_grad()
        total.backward()
        return items.detach(), torch.cat([p.grad.reshape(-1) for p in optimizer.params]).cpu()

    for s in range(DP_STEPS):
        ranks = [torch.load(work / f"step{s}.{r}.pt", weights_only=False)
                 for r in range(DP_WORLD)]
        state = torch.load(work / f"state{s}.pt", weights_only=True)
        # the ranks' codes, image-concatenated: FAM then ODM
        codes = [torch.cat([r["codes"][i] for r in ranks]) for i in range(2)]
        log = {"stats": [], "codes": []}
        items, grad = one_process(state, codes, log)
        # the floor: one process against itself with its input scaled by
        # 1 + 1e-6. From a random initialisation the step is ill-conditioned
        # (train-mode BN, ReLU and max-pool flips): at R-50 256^2 on the CPU
        # that alone moved the gradient 3.2e-2 of its norm, each tensor up
        # to 4%, as much as two ranks against one process did (2.8e-2)
        _, grad2 = one_process(state, codes, {"stats": [], "codes": []}, 1 + 1e-6)
        floor = ((grad2 - grad).norm() / grad.norm()).item()
        dp = ranks[0]

        def stats_err(got, want):
            """Per channel, on the scale of the sums the statistics come
            from: the mean's error over the root mean square sqrt(E[x^2]),
            the variance's over E[x^2] (var = E[x^2] - mean^2 in float32
            loses what the sums' rounding leaves of E[x^2]); the largest
            over the layers, and the worst layer."""
            e = []
            for a, b in zip(got, want):
                ms = b[1] + b[0] * b[0] + 1e-5  # E[x^2]
                e.append(max(((a[0] - b[0]).abs() / ms.sqrt()).max().item(),
                             ((a[1] - b[1]).abs() / ms).max().item()))
            return max(e), max(range(len(e)), key=e.__getitem__)

        # each layer: the ranks' statistics against those of the ranks' own
        # inputs (their float64 sums, added), and against one process's,
        # whose inputs drift from the ranks' by the rounding of every
        # layer before (other convolution algorithms at batch 4 and 8)
        own = []
        for layer in zip(*(r["sums64"] for r in ranks)):
            tot, m = sum(t for t, _ in layer), sum(m for _, m in layer)
            mean = tot[0] / m
            own.append((mean.float(), (tot[1] / m - mean * mean).float()))
        e_own, l_own = stats_err(dp["stats"], own)
        e_one, l_one = stats_err(dp["stats"], log["stats"])
        check(len(dp["stats"]) == len(log["stats"]) == layers and e_own <= 1e-5
              and e_one <= 1e-4,
              f"{label} float32 step {s}: the {layers} BN layers' forward mean and var (per "
              f"channel: the mean over sqrt(E[x^2]), the var over E[x^2]) within "
              f"{e_own:.3g} of the statistics of the ranks' own inputs in float64 (bar 1e-5; "
              f"layer {l_own}), within {e_one:.3g} of one process's at batch {BATCH} (bar 1e-4; "
              f"layer {l_one}: the inputs drift with the layers before)")
        own = log["codes"]  # one process's own codes
        differ = [int((a != b).sum()) for a, b in zip(codes, own)]
        pos_dp = [int((c >= 0).sum()) for c in codes]
        pos_one = [int((c >= 0).sum()) for c in own]
        check(pos_dp[0] == pos_one[0] and abs(pos_dp[1] - pos_one[1]) <= differ[1]
              and differ[0] == 0,
              f"{label} step {s}: positives over the global batch FAM {pos_dp[0]} / one "
              f"process {pos_one[0]} (exact), ODM {pos_dp[1]} / {pos_one[1]}; codes that "
              f"differ FAM {differ[0]}, ODM {differ[1]} of {codes[1].numel()}")
        g_err = ((dp["grad"] - grad).norm() / grad.norm()).item()
        i_err = ((dp["items"] - items.cpu()).abs() / items.cpu().abs()).max().item()
        names = [n for n, q in model.named_parameters() if q.requires_grad]
        sizes = [q.numel() for q in optimizer.params]

        def per_tensor(other):
            return sorted(((((a - b).norm() / b.norm().clamp_min(1e-30)).item(), n)
                           for n, a, b in zip(names, other.split(sizes), grad.split(sizes))),
                          reverse=True)
        per, per_floor = per_tensor(dp["grad"]), per_tensor(grad2)
        say(f"   {label} step {s}: gradient tensors furthest from one process's, relative to "
            f"their norm: " + "; ".join(f"{n} {e:.3g}" for e, n in per[:4])
            + "; the floor's: " + "; ".join(f"{n} {e:.3g}" for e, n in per_floor[:2]))
        # a sum that misses a rank is off by about half of each tensor, one
        # that adds the BNs' global gamma and beta again by all of theirs
        check(g_err <= max(3 * floor, 1e-3) and per[0][0] <= 0.25 and i_err <= 1e-4,
              f"{label} step {s}: the gradient summed over the ranks within {g_err:.3g} of one "
              f"process's, relative to its norm (bar max(3 x floor, 1e-3); the floor, one "
              f"process against its input scaled by 1 + 1e-6: {floor:.3g}), each tensor within "
              f"{per[0][0]:.3g} of its norm (bar 0.25; floor {per_floor[0][0]:.3g}); loss items "
              f"within {i_err:.3g} (relative, bar 1e-4) on the ranks' assignment")
    del model, optimizer, batches, batch
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True
    trees = dp_trees(train_cli, train_step, base + ["--dtype", "bfloat16"], parent)
    walls, _ = dp_timed(trees)
    one_prof = dp_profiled(torch, trees, True) if parent is not None and dev.type == "cuda" else {}
    del trees
    torch.cuda.empty_cache()
    timing = json.loads((work / "timing.0.json").read_text())
    res = {"backend": timing["backend"]}
    for name in walls:
        key = "" if name == "this tree" else "parent_"
        res[key + "dp_ms"] = median_spread(timing["walls"][name])
        res[key + "one_ms"] = median_spread(walls[name])
    per = timing["launches"]["this tree"]
    check(per["s2a_bn_apply_finish"] == per["s2a_bn_dx_finish"] == 53
          and per["s2a_channel_moments"] == per["s2a_grad_channel_sums"] == 53
          and per["s2a_bn_apply"] == per["s2a_bn_dx"] == 0
          and per["s2a_deform_conv2d_fwd"] == per["s2a_deform_conv2d_bwd"] == 5
          and per["s2a_box_iou_rotated"] == 2,
          f"{label} launches a step on rank 0: {per}")
    if parent is not None:
        say(f"   {label} the earlier tree's launches a step on rank 0: "
            f"{timing['launches']['parent']}")
    if one_prof:
        res["profiled"] = dp_launch_diff(one_prof, timing["profiled"], label)
    return per, res


def dp_launch_diff(one, ranks, label: str):
    """Holds the profiled steps of this tree and the earlier one (cuDNN
    without autotuning): in one process the same launches name for name; on
    rank 0 of the data-parallel step 106 fewer, the BN layers' finishing
    kernels gone (53 + 53) and s2a_bn_apply / s2a_bn_dx turned into the fused
    kernels, every other name the same. Returns the totals."""
    def is_bn(name):
        return "finish_sums" in name or "bn_apply" in name or "bn_dx" in name

    def count(prof, word):
        return sum(c for name, c in prof.items() if word in name)

    tot = {k: (sum(one[k].values()), sum(ranks[k].values())) for k in one}
    check(one["this tree"] == one["parent"],
          f"{label} one process, a profiled bf16 step: {tot['this tree'][0]} launches in "
          f"{len(one['this tree'])} kernels on this tree, {tot['parent'][0]} on the earlier one, "
          f"name for name (differing: "
          f"{sorted(set(one['this tree'].items()) ^ set(one['parent'].items()))[:6]})")
    this, par = ranks["this tree"], ranks["parent"]
    same = ({n: c for n, c in this.items() if not is_bn(n)}
            == {n: c for n, c in par.items() if not is_bn(n)})
    moved = {"earlier finishing": count(par, "finish_sums"),
             "earlier apply / dx": (count(par, "bn_apply"), count(par, "bn_dx")),
             "fused apply / dx": (count(this, "bn_apply_finish"), count(this, "bn_dx_finish")),
             "this tree's finishing": count(this, "finish_sums")}
    check(tot["parent"][1] - tot["this tree"][1] == 106 and same
          and moved["earlier finishing"] == 106 and moved["earlier apply / dx"] == (53, 53)
          and moved["fused apply / dx"] == (53, 53) and moved["this tree's finishing"] == 0,
          f"{label} rank 0, a profiled data-parallel bf16 step: {tot['this tree'][1]} launches "
          f"on this tree against {tot['parent'][1]} on the earlier one "
          f"({tot['this tree'][1] - tot['parent'][1]:+d}); {moved}; every other name the same "
          f"count: {same}")
    return tot


def dp_fused(torch, dev, card):
    """Phase 16's kernel checks and times: the fused finishing kernels
    against the one-launch path and against their plain versions at the 53
    R-50 BN shapes (statistics from none, 2 or all 8 images of the rank's
    rows), zero rows, and their time over a step's 53 layers beside
    s2a_bn_apply and s2a_bn_dx alone; returns their rows."""
    from s2anet_tpu_torch.ops import moments as mo

    eps, keep = 1e-5, 0.9
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(b, h, w, c) for b, c, h, w in bn_input_shapes(torch, "resnet50", BATCH, SIZE)]
    kernels = (mo.APPLY_FINISH, mo.DX_FINISH, mo.APPLY, mo.DX)
    equal, launches_ok = True, True
    err = {"apply": 0.0, "dx": 0.0}  # fused kernel against its plain version, max |a - b|
    rel = {"apply": 0.0, "dx": 0.0}  # y, dx: over the largest |value|
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
    tol_ok = True
    data = []

    def run(c):  # running mean, var and count
        return (torch.zeros(c, device=dev), torch.ones(c, device=dev),
                torch.tensor(5, device=dev))
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            b, h, w, c = shape
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).to(dtype)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            weight = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = torch.randn(c, generator=gen, device=dev)
            for prefix in (0, 2, b):  # 0: statistics rows on another rank
                k = prefix or b
                n, stat_rows = k * h * w, prefix * h * w
                # the one-process path: sums and finishing in one launch,
                # then apply, and dx on the two row ranges
                r1 = run(c)
                st1 = mo.bn_stats(x[:k], weight, *r1, eps, keep)
                y1 = mo.bn_apply(x, st1[0], st1[3], bias)
                dg1, db1, a, bb = mo.bn_grad(g, x, st1[0], st1[2], n)
                dx1 = torch.empty_like(x)
                if prefix:
                    mo.bn_dx(g[:prefix], x[:prefix], st1[0], st1[3], a, bb, out=dx1[:prefix])
                zero = torch.zeros_like(a)
                mo.bn_dx(g[prefix:], x[prefix:], st1[0], st1[3], zero, zero, out=dx1[prefix:])
                # the data-parallel path: the sums alone, then the fused kernels
                s_x, s_g = mo.moment_sums(x[:k]), mo.pair_sums(g, x)
                r2 = run(c)
                before = [kern.launches for kern in kernels]
                y2, st2 = mo.bn_apply_finish(x, s_x, n, weight, bias, *r2, eps, keep)
                dx2, dg2, db2 = mo.bn_dx_finish(g, x, s_g, n, st2[0], st2[2], st2[3], stat_rows)
                launches_ok &= [kern.launches - n0 for kern, n0 in zip(kernels, before)] == [
                    1, 1, 0, 0]
                equal &= int(r2[2]) == 6 and all(torch.equal(p, q) for p, q in zip(
                    (*st1, *r1, y1, dg1, db1, dx1), (*st2, *r2, y2, dg2, db2, dx2)))
                # the fused plain versions on the same sums
                r3 = run(c)
                y3, st3 = mo.bn_apply_finish_plain(x, s_x, n, weight, bias, *r3, eps, keep)
                dx3, dg3, db3 = mo.bn_dx_finish_plain(g, x, s_g, n, st2[0], st2[2], st2[3],
                                                      stat_rows)
                err["apply"] = max(err["apply"], *((p.float() - q.float()).abs().max().item()
                                                   for p, q in zip((*st2, *r2[:2], y2),
                                                                   (*st3, *r3[:2], y3))))
                err["dx"] = max(err["dx"], *((p.float() - q.float()).abs().max().item()
                                             for p, q in zip((dg2, db2, dx2), (dg3, db3, dx3))))
                ry, rdx = rel_to_max(y2.float(), y3.float()), rel_to_max(dx2.float(), dx3.float())
                rel["apply"], rel["dx"] = max(rel["apply"], ry), max(rel["dx"], rdx)
                tol_ok &= ry <= ulp[dtype] and rdx <= ulp[dtype] and int(r3[2]) == 6 and max(
                    (p - q).abs().max().item()
                    for p, q in zip((*st2, *r2[:2], dg2, db2), (*st3, *r3[:2], dg3, db3))) <= 1e-5
            if dtype == torch.bfloat16:  # the full batch's, for the times below
                data.append(dict(x=x, g=g, w=weight, bias=bias, sx=s_x, sg=s_g, n=n, rows=n,
                                 run=run(c), mean=st1[0], rstd=st1[2], mul=st1[3], a=a, b=bb))
            del x, g, y1, y2, y3, dx1, dx2, dx3
    torch.cuda.synchronize()
    check(equal and launches_ok and len(shapes) == 53,
          "sums alone + s2a_bn_apply_finish / s2a_bn_dx_finish equal the one-launch sums and "
          "finishing + s2a_bn_apply / s2a_bn_dx (two row ranges) bit for bit (statistics, "
          "running statistics, count, y, dgamma, dbeta, dx) at the 53 R-50 BN shapes, bf16 and "
          "float32, stat_rows 0 / 2*H*W / all; one launch of each fused kernel a call, none of "
          "s2a_bn_apply / s2a_bn_dx")
    check(tol_ok, f"fused kernels against their plain versions on the same sums: max |kernel - "
          f"plain| statistics, running statistics and y {err['apply']:.3g}, dgamma, dbeta and dx "
          f"{err['dx']:.3g} (bar 1e-5 on the per-channel outputs); y within {rel['apply']:.3g}, "
          f"dx within {rel['dx']:.3g} of the largest value (bar one ulp: bf16 2^-7, float32 "
          f"1e-5)")
    x = torch.randn(2, 4, 4, 64, device=dev).bfloat16()
    out = torch.full((2, 64), float("nan"), device=dev)
    mo.MOMENTS(x.data_ptr(), out.data_ptr(), None, None, 0, 64, 8, 1, None, None, None, None,
               1e-5, 0.9, 0.1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(torch.equal(out, torch.zeros_like(out))
          and torch.equal(mo.moment_sums(x[:0]), torch.zeros(2, 64, device=dev))
          and torch.equal(mo.pair_sums(x[:0], x[:0]), torch.zeros(2, 64, device=dev)),
          "zero rows: zero sums (the entry point writes them over NaN; the wrappers, no launch)")

    # over a step's 53 bf16 layers: each fused kernel in turns with the
    # kernel it replaces alone (events over the sweep), the device time of
    # each (profiler), the host's time to enqueue each sweep, the fused plain
    # versions, and torch.batch_norm_backward_elemt (dx from all-reduced
    # sums, SyncBatchNorm's; it takes sum g*(x - mean) and writes no dgamma)
    lib_in = []
    for d in data:
        xc, gc = d["x"].permute(0, 3, 1, 2), d["g"].permute(0, 3, 1, 2)
        lib_in.append((gc, xc, d["mean"], d["rstd"], d["w"], d["sg"][0],
                       d["sg"][1] - d["mean"] * d["sg"][0],
                       torch.tensor([d["n"]], dtype=torch.int32, device=dev)))
    sweeps = {
        "apply": lambda: [mo.bn_apply_cuda(d["x"], d["mean"], d["mul"], d["bias"]) for d in data],
        "apply_finish": lambda: [mo.bn_apply_finish_cuda(d["x"], d["sx"], d["n"], d["w"],
                                                         d["bias"], *d["run"], eps, keep)
                                 for d in data],
        "dx": lambda: [mo.bn_dx_cuda(d["g"], d["x"], d["mean"], d["mul"], d["a"], d["b"])
                       for d in data],
        "dx_finish": lambda: [mo.bn_dx_finish_cuda(d["g"], d["x"], d["sg"], d["n"], d["mean"],
                                                   d["rstd"], d["mul"], d["rows"]) for d in data],
    }
    ev = {}
    for alone, fused in (("apply", "apply_finish"), ("dx", "dx_finish")):
        ev[alone], ev[fused] = paired_ms(torch, sweeps[alone], sweeps[fused], 3)
    dev_ms = {k: sum(kernel_split(torch, fn).values()) for k, fn in sweeps.items()}
    host = {k: host_ms(torch, fn) for k, fn in sweeps.items()}
    plain = {
        "apply_finish": cuda_ms(torch, lambda: [mo.bn_apply_finish_plain(
            d["x"], d["sx"], d["n"], d["w"], d["bias"], *d["run"], eps, keep) for d in data], 1),
        "dx_finish": cuda_ms(torch, lambda: [mo.bn_dx_finish_plain(
            d["g"], d["x"], d["sg"], d["n"], d["mean"], d["rstd"], d["mul"], d["rows"])
            for d in data], 1)}
    lib_ms = cuda_ms(torch, lambda: [torch.batch_norm_backward_elemt(*a) for a in lib_in], 3)
    # bytes: each input read once and each output written once. apply_finish:
    # x, y (2 bytes an element), float32 sums [2, C], gamma, beta, the running
    # pair read, out [6, C] and the running pair written, the count; about 3
    # operations an element and 12 a channel. dx_finish: g, x, dx, sums [2, C],
    # mean, rstd, mul read, out [5, C] written; 5 an element, 8 a channel
    e = [d["x"].numel() for d in data]
    cs = [d["x"].shape[-1] for d in data]
    b_apply = bound(sum(4 * n + 56 * c + 8 for n, c in zip(e, cs)),
                    sum(3 * n + 12 * c for n, c in zip(e, cs)), F32_FLOP_S)
    b_dx = bound(sum(6 * n + 40 * c for n, c in zip(e, cs)),
                 sum(5 * n + 8 * c for n, c in zip(e, cs)), F32_FLOP_S)
    for alone, fused, bd, what in (("apply", "apply_finish", b_apply, "s2a_bn_apply"),
                                   ("dx", "dx_finish", b_dx, "s2a_bn_dx")):
        say(f"   s2a_bn_{fused} over the 53 bf16 layers of a step: events over the sweep "
            f"{ev[fused][0]:.3f} ms (spread {ev[fused][1]:.1%}) in turns with {what} alone "
            f"{ev[alone][0]:.3f} ms ({ev[alone][1]:.1%}): {ev[fused][0] / ev[alone][0] - 1:+.1%}; "
            f"device time (profiler) {dev_ms[fused]:.3f} ms against {dev_ms[alone]:.3f} "
            f"({dev_ms[fused] / dev_ms[alone] - 1:+.1%}); the host's enqueue {host[fused]:.3f} ms "
            f"({1e3 * host[fused] / len(data):.1f} us a call) against {host[alone]:.3f}; bound "
            f"{bd[0]:.3f} ms ({bd[1]}): {bd[0] / dev_ms[fused]:.1%} of it; fused plain "
            f"{plain[fused][0]:.3f} ms; {card}")
    say(f"   torch.batch_norm_backward_elemt over the same 53 layers (dx from all-reduced sums, "
        f"the library's one call): {lib_ms[0]:.3f} ms (spread {lib_ms[1]:.1%})")
    del data, lib_in, sweeps
    torch.cuda.empty_cache()
    return {
        key: dict(max_abs_err=err[key], ms=ev[fused][0], device_ms=dev_ms[fused],
                  host_enqueue_ms=host[fused], plain_ms=plain[fused][0], bound_ms=bd[0],
                  bound_by=bd[1], library_ms=lib, alone_ms=ev[alone][0],
                  alone_device_ms=dev_ms[alone], alone_host_enqueue_ms=host[alone],
                  max_rel_err=rel[key])
        for key, alone, fused, bd, lib in (("apply", "apply", "apply_finish", b_apply, None),
                                           ("dx", "dx", "dx_finish", b_dx, lib_ms[0]))}


def dp_two_ranks(torch, dev, out_dir, card, parent=None):
    """Phase 16a: two ranks sharing the card over gloo against one process
    (each tree's, in turns, given ``parent``); returns the launches of a
    data-parallel step on rank 0."""
    work = out_dir / "dp"
    shutil.rmtree(work, ignore_errors=True)
    say(f"   16a: {DP_WORLD} ranks spawned on the one card (gloo), R-50 {SIZE}^2, global batch "
        f"{BATCH} ({BATCH // DP_WORLD} a rank); {DP_STEPS} float32 steps against one process, "
        f"then bf16 ms/step" + (f", in turns with the earlier tree {parent}" if parent else ""))
    t0 = time.perf_counter()
    dp_world(torch, work, share=True, parent=parent)
    say(f"   the ranks' run: {time.perf_counter() - t0:.1f} s (start, build, steps)")
    per, res = dp_compare(torch, dev, work, "16a", parent=parent)
    check(res["backend"] == "gloo", f"16a backend {res['backend']} (ranks share the card)")
    say(f"   16a bf16: {dp_rates(res, 'ranks sharing the card')}; gloo copies every CUDA "
        f"all-reduce through the host and the ranks share one card: a correctness path, not a "
        f"rate; {card}")
    shutil.rmtree(work, ignore_errors=True)
    return per


def dp_rates(res, what: str) -> str:
    """The ms/step of dp_compare's result, and the earlier tree's beside."""
    def one(key):
        (dp, sp), (one_ms, one_sp) = res[key + "dp_ms"], res[key + "one_ms"]
        return (f"{DP_WORLD} {what} {dp:.2f} ms/step (spread {sp:.1%}, "
                f"{1000 * BATCH / dp:.2f} img/s of the global batch) against one process at "
                f"batch {BATCH} {one_ms:.2f} ms/step (spread {one_sp:.1%})")
    out = "this tree: " + one("")
    if "parent_dp_ms" in res:
        out += (f"; the earlier tree, in turns: {one('parent_')}; data parallel "
                f"{res['dp_ms'][0] / res['parent_dp_ms'][0] - 1:+.1%}, one process "
                f"{res['one_ms'][0] / res['parent_one_ms'][0] - 1:+.1%}")
    if "profiled" in res:
        out += (f"; profiled launches (one process, rank 0) this tree {res['profiled']['this tree']}"
                f", earlier {res['profiled']['parent']}")
    return out


def dp_cli(torch, out_dir):
    """Phase 16b: the training CLI under torchrun, two ranks on the card,
    then a resume in one process and val on the deploy weights."""
    import csv
    import os

    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.data import synth
    from s2anet_tpu_torch.train import __main__ as train_cli

    say("   16b: the CLI under torchrun")
    root = out_dir / "dp_cli"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    synth.write_split(root / "train", DP_TRAIN, rng, SIZE, 15, 3)
    synth.write_split(root / "val", DP_VAL, rng, SIZE, 15, 3)
    cfg_path = str(ROOT / "configs" / "dota_r50.yaml")
    args = ["--config", cfg_path, "--data-root", str(root / "train" / "images"), "--val-root",
            str(root / "val" / "images"), "--batch-size", str(BATCH), "--seed", str(SEED),
            "--save-dir", str(root / "run")]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DP_WORLD), "-m", "s2anet_tpu_torch.train"] + args + ["--epochs", "1"]
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    say(f"   {' '.join(cmd[2:])}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    (out_dir / "dp_torchrun.log").write_text(proc.stdout + "\n" + proc.stderr)
    check(proc.returncode == 0, f"torchrun exit {proc.returncode} in {wall:.1f} s "
          f"(stderr tail: {proc.stderr[-600:]!r})")
    summaries = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    run = root / "run"

    def results():
        with open(run / "results.csv", newline="") as f:
            return list(csv.DictReader(f))
    rows = results()
    ckpt = torch.load(run / "weights" / "last", map_location="cpu", weights_only=True)
    check(len(summaries) == 1 and summaries[0]["ranks"] == DP_WORLD
          and summaries[0]["steps"] == DP_TRAIN // BATCH and len(rows) == 1
          and "backend gloo" in proc.stdout
          and all(np.isfinite(float(v)) for k, v in rows[0].items()
                  if k.startswith(("train/", "val/")))
          and all((run / "weights" / n).is_file() for n in ("last", "best", "deploy"))
          and not any(k.startswith("module.") for part in ("model", "ema") for k in ckpt[part]),
          f"{DP_WORLD} ranks, {wall:.1f} s: one summary from rank 0 "
          f"({summaries[0]['steps'] if summaries else '?'} steps, "
          f"{summaries[0]['ms_per_step'] if summaries else float('nan'):.2f} ms/step to the "
          f"device's end, validation {summaries[0]['val_seconds'] if summaries else '?'} s), "
          f"one results.csv row, weights/last, best, deploy, keys without 'module.'; "
          f"{[x for x in proc.stdout.splitlines() if x.startswith('data parallel')]}")
    resumed = train_cli.main(args + ["--epochs", "2", "--resume", str(run / "weights" / "last")])
    rows = results()
    check(resumed["ranks"] == 1 and resumed["updates"] == 2 * (DP_TRAIN // BATCH)
          and [r["epoch_or_step"] for r in rows] == ["0", "1"],
          f"the {DP_WORLD}-rank weights/last resumed in one process: epoch 1, "
          f"{resumed['updates']} updates in all")
    out = port_val.main(["--config", cfg_path, "--weights", str(run / "weights" / "deploy"),
                         "--data-root", str(root / "val" / "images")])
    check(0.0 <= out["map50"] <= 1.0, f"val on the deploy weights: mAP50 {out['map50']:.4f}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def dp_nccl(torch, dev, out_dir, card, parent=None):
    """Phase 16c: NCCL, one card a rank, where there are two cards."""
    work = out_dir / "dp"
    gpus = torch.cuda.device_count()
    if gpus >= DP_WORLD:
        say(f"   16c: {DP_WORLD} ranks on {DP_WORLD} of {gpus} cards (NCCL)")
        dp_world(torch, work, share=False, parent=parent)
        _, res = dp_compare(torch, dev, work, "16c", parent=parent)
        check(res["backend"] == "nccl", f"16c backend {res['backend']}")
        say(f"   16c bf16: {dp_rates(res, 'cards')}; {card}")
        shutil.rmtree(work, ignore_errors=True)
    else:
        say(f"   16c skipped: {gpus} card(s) here; NCCL with one rank a card needs "
            f"{DP_WORLD} (16a and 16b ran, over gloo)")


def phase_data_parallel(torch, dev, out_dir, parent=None):
    """Section 16 of the module docstring; returns the fused finishing
    kernels' rows and the launches a data-parallel step."""
    import importlib

    say("== 16. data parallel")
    card = card_line()
    if parent is not None:  # the earlier tree's kernels, built once for the ranks
        load_parent(parent)
        importlib.import_module(PARENT_PKG + "._ext").build(
            ("deform_conv", "iou_nms_rotated", "bn_moments"))
    fused = dp_fused(torch, dev, card)
    per = dp_two_ranks(torch, dev, out_dir, card, parent)
    dp_cli(torch, out_dir)
    dp_nccl(torch, dev, out_dir, card, parent)
    return fused, per


# phase 17: spatial serving
SCENE_HW = (3000, 4000)  # phase 11's scene; padded to 3072x4096
SQUARE_HW = (4096, 4096)
SPATIAL_B_HW = (1000, 1400)  # 17b: padded to 1024x1408 on 1 and on 2 ranks
SPATIAL_TURNS = 5
SPATIAL_RANKS = 2
# phase 17's weights: the seeded R-50 with the ODM class head's kernel
# scaled so that a share ODM_PASS of the (anchor, class) scores of a
# scene-like 1024^2 image pass predict's threshold 0.3 (a few hundred on
# the 3000x4000 scene): the scores then spread over (0, 1) instead of
# sitting within ~1e-5 of the prior 0.01, where two float32 paths'
# roundings reorder them
ODM_PASS = 1e-4


def spatial_weights(torch, dev, cfg, path: Path) -> float:
    """Phase 17's weights (see ``ODM_PASS``) as a state_dict file; returns
    the scale of the class head's kernel."""
    from s2anet_tpu_torch.models.detector import S2ANet

    model = S2ANet.from_config(cfg).init_weights(torch.Generator().manual_seed(SEED))
    model = model.eval().to(dev)
    rng = np.random.default_rng(SEED + 16)
    img = rng.integers(0, 90, (SIZE, SIZE, 3), dtype=np.uint8)
    draw_objects(rng, img, 60)
    x = torch.from_numpy(img).to(dev).permute(2, 0, 1)[None].float() / 255.0
    head = model.head.odm_cls_head
    with torch.no_grad():
        logits = torch.cat([c.reshape(-1, c.shape[-1]) for c in model(x)["odm_cls"]])
        q = torch.quantile((logits - head.bias).reshape(-1).float(), 1 - ODM_PASS).item()
        target = float(np.log(0.3 / 0.7)) - head.bias[0].item()  # the logit of 0.3
        check(q > 0, f"phase 17 weights: the class logits' {1 - ODM_PASS:.4%} quantile {q:.3g} "
              f"above the prior's")
        head.weight.mul_(target / q)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    return target / q


def pad_scene(scene, world: int = 1):
    """``[1, H, W, 3]`` uint8: the scene zero-padded as ``predict --mode
    spatial`` pads it for ``world`` ranks."""
    from s2anet_tpu_torch.parallel.spatial import padded_size

    h, w = scene.shape[:2]
    hp, wp = padded_size(h, w, world)
    out = np.zeros((1, hp, wp, 3), np.uint8)
    out[0, :h, :w] = scene
    return out


def scene_dets(torch, pred, img, **kw):
    """NumPy ``(boxes, labels, valid)`` of a padded image ``[1, H, W, 3]``
    through the spatial step in this process (one rank)."""
    from s2anet_tpu_torch.parallel import spatial

    with torch.no_grad():
        out = spatial.spatial_predict(pred.forward, pred.to_input(img),
                                      **dict(pred.post_kwargs(), **kw))
    return tuple(t.cpu().numpy() for t in out)


def score_gap(torch, pred, img, lo: int = 30, hi: int = 100) -> float:
    """A score threshold in the widest gap between the ``lo``-th and
    ``hi``-th highest (anchor, class) scores of the whole image: no score
    lies near it."""
    with torch.no_grad():
        out = pred.forward(pred.to_input(img))
    s = torch.cat([torch.sigmoid(c.float()).reshape(-1) for c in out["odm_cls"]])
    s = torch.sort(s, descending=True).values[:hi].cpu().numpy()
    i = lo + int(np.argmax(s[lo - 1:hi - 1] - s[lo:hi]))
    return float((s[i - 1] + s[i]) / 2)


def det_lines(torch, dets, names):
    """The ``<name>.txt`` lines ``predict`` writes for ``(boxes, labels,
    valid)`` of one image."""
    from s2anet_tpu_torch.eval.runner import detections_to_polys

    boxes, labels, valid = (a[0] for a in dets)
    polys, scores = detections_to_polys(boxes, valid)
    return [f"{names[c]} {s:.4f} " + " ".join(f"{v:.2f}" for v in p)
            for c, s, p in zip(labels[valid], scores, polys)]


def parse_lines(lines, names):
    """``(labels [n], scores [n], polys [n, 8])`` of ``predict`` lines."""
    index = {n: i for i, n in enumerate(names)}
    rows = [line.split() for line in lines]
    return (np.array([index[r[0]] for r in rows], np.int64),
            np.array([float(r[1]) for r in rows]),
            np.array([[float(v) for v in r[2:]] for r in rows]).reshape(-1, 8))


def lines_agree_f32(got, want, names) -> str:
    """The float32 bar on two runs' lines, in order: as many (``valid``),
    the same labels, scores and polygon vertices within rtol 1e-4 / atol
    1e-3 plus what the file's rounding can put between two values (1e-4
    of a score, 0.01 px); returns "" or what failed."""
    lg, sg, pg = parse_lines(got, names)
    lw, sw, pw = parse_lines(want, names)
    if len(lg) != len(lw):
        return f"{len(lg)} detections against {len(lw)}"
    if not np.array_equal(lg, lw):
        return f"labels differ at {np.nonzero(lg != lw)[0][:5].tolist()}"
    if not np.allclose(sg, sw, rtol=1e-4, atol=1e-3 + 1e-4):
        return f"scores differ by up to {np.abs(sg - sw).max():.3g}"
    if not np.allclose(pg, pw, rtol=1e-4, atol=1e-3 + 1e-2):
        return f"vertices differ by up to {np.abs(pg - pw).max():.3g} px"
    return ""


def lines_matched_iou(torch, dev, got, want, names) -> float:
    """Lines matched 1:1 by (label, score within 1e-3, rotated IoU >= 0.5),
    as a fraction of the larger count (the bf16 bar)."""
    from s2anet_tpu_torch.ops import iou_rotated as iou
    from s2anet_tpu_torch.ops.rbox import poly_to_rbox_np

    parsed = []
    for lines in (got, want):
        lab, sc, polys = parse_lines(lines, names)
        rb = poly_to_rbox_np(polys).astype(np.float32)
        parsed.append((np.concatenate([rb, sc[:, None]], 1), lab))
    (a, la), (b, lb) = parsed
    ious = iou.box_iou_rotated_plain(torch.from_numpy(a[:, :5]).to(dev),
                                     torch.from_numpy(b[:, :5]).to(dev)).cpu().numpy()
    return match_1to1(a, la, b, lb, ious) / max(len(a), len(b), 1)


def emulated_rows(torch, fn, x, off, clamp: float, world: int):
    """``rows.deform_rows(fn, ...)`` as each of ``world`` ranks runs it,
    in this process: the exchanges are served from the whole ``x`` and
    ``off``; the ranks' outputs concatenated (phase 17c)."""
    from s2anet_tpu_torch.parallel import mesh, rows

    h = x.shape[1] // world
    outs = []
    for r in range(world):
        def halo(t, top, bottom, dim, r=r):
            zeros = t.new_zeros((t.shape[0], max(top, bottom)) + tuple(t.shape[2:]))
            above = x[:, r * h - top:r * h] if r > 0 else zeros[:, :top]
            below = x[:, (r + 1) * h:(r + 1) * h + bottom] if r < world - 1 else zeros[:, :bottom]
            return above, below

        def gather(t, dim):
            return x if t.dim() == 4 else off

        with mock.patch.object(mesh, "world_size", lambda: world), \
                mock.patch.object(mesh, "rank", lambda r=r: r), \
                mock.patch.object(mesh, "halo_rows", halo), \
                mock.patch.object(mesh, "gather_rows", gather), rows.sharded():
            outs.append(rows.deform_rows(fn, x[:, r * h:(r + 1) * h],
                                         off[:, r * h:(r + 1) * h], clamp))
    return torch.cat(outs, 1)


def spatial_halo_card(torch, dev, gen, card):
    """Phase 17c: the AlignConv kernel on halo-extended and gathered blocks
    against the unsharded kernel, at the scene's level shapes."""
    from s2anet_tpu_torch.ops import deform_conv as dc

    say("   17c: the AlignConv halo on the card (the ranks' exchanges served in this "
        "process) against the unsharded kernel")
    h3, w3 = pad_scene(np.zeros(SCENE_HW + (1,), np.uint8)).shape[1:3]
    h3, w3 = h3 // 8, w3 // 8
    hb, wb = SPATIAL_B_HW[0] // 8 + 3, SPATIAL_B_HW[1] // 8 + 1  # 17b's P3: 128 x 176
    cases = [  # name, (h, w), ranks, clamp: taller than the halo, thinner, clamp 0
        ("17b's P3 on 2 ranks, halo", (hb, wb), 2, 6.0),
        ("the scene's P3 on 2 ranks, halo", (h3, w3), 2, 6.0),
        ("the scene's P5 on 4 ranks, halo", (h3 // 4, w3 // 4), 4, 6.0),
        ("the scene's P7 on 4 ranks, gathered", (h3 // 16, w3 // 16), 4, 6.0),
        ("the scene's P4 on 2 ranks, clamp 0, gathered", (h3 // 2, w3 // 2), 2, 0.0),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, (h, w), world, clamp in cases:
            # float32: 1e-5 (JAX's bar for its halo, on maps under 128 rows);
            # the kernel's tap rows are float32 sums of the row, the tap and
            # the offset, so a map's own rounding grows with its height,
            # while a halo block's rows stay small: h / 128 x 1e-5 past 128
            tol = 1e-5 * max(1.0, h / 128) if dtype == torch.float32 else 2e-2
            x = torch.randn(1, h, w, 256, generator=gen, device=dev).to(dtype)
            reach = clamp if clamp > 0 else 20.0
            off = ((torch.rand(1, h, w, 9, 2, generator=gen, device=dev) * 2 - 1)
                   * reach).to(dtype)
            wt = (torch.randn(3, 3, 256, 256, generator=gen, device=dev) * 0.05).to(dtype)
            want = dc.deform_conv2d_cuda(x, off, wt)
            got = emulated_rows(torch, lambda xs, os: dc.deform_conv2d_cuda(xs, os, wt),
                                x, off, clamp, world)
            torch.cuda.synchronize()
            err = rel_to_max(got.float(), want.float())
            if dtype == torch.float32:
                worst = max(worst, err)
            check(got.shape == want.shape and err <= tol,
                  f"{name} {str(dtype)[6:]} [1, {h}, {w}, 256]: max |sharded - unsharded| "
                  f"{err:.3g} of the largest value (bar {tol:g})")
    return worst


def spatial_cli_runs(torch, dev, work: Path, wfile: Path, names):
    """Phase 17b: ``predict --mode spatial`` under torchrun on 2 ranks
    sharing the card (gloo), float32 at clamp 6 and 0 on phase 17's
    weights and bf16 at clamp 6 on the seeded weights, the three at once,
    each against this process on the same scene and weights."""
    import dataclasses
    import os

    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch.config import load_config

    rng = np.random.default_rng(SEED + 17)
    scene = rng.integers(0, 90, SPATIAL_B_HW + (3,), dtype=np.uint8)
    draw_objects(rng, scene, 40)
    (work / "b_src").mkdir(parents=True, exist_ok=True)
    np.save(work / "b_src" / "scene_b.npy", scene)
    clamp0 = work / "clamp0.yaml"
    clamp0.write_text((ROOT / "configs" / "dota_r50.yaml").read_text().replace(
        "align_offset_clamp: 6.0", "align_offset_clamp: 0.0"))
    configs = {6.0: ROOT / "configs" / "dota_r50.yaml", 0.0: clamp0}
    img = pad_scene(scene, SPATIAL_RANKS)
    check(pad_scene(scene, 1).shape == img.shape, f"17b scene {SPATIAL_B_HW} pads alike on "
          f"1 and {SPATIAL_RANKS} ranks: {img.shape[1:3]}")
    # float32 on phase 17's weights at a threshold in a gap of the scores;
    # bf16 on the seeded weights at 0.005, as phases 5 and 11 hold bf16
    # (there the scaled class head turns bf16 roundings into score
    # differences above the match's 1e-3)
    runs = [("float32", 6.0, str(wfile)), ("float32", 0.0, str(wfile)), ("bfloat16", 6.0, "")]
    refs, thr = {}, {}
    # the CLI's autotuning setting: two ranks autotuning on one card at
    # once may choose other algorithms than this process, and in bf16 those
    # move random-weight detections past the bar
    torch.backends.cudnn.benchmark = port_predict.CUDNN_BENCHMARK["spatial"]
    for dtype, clamp, weights in runs:
        torch.backends.cudnn.allow_tf32 = dtype != "float32"
        cfg = load_config(str(configs[clamp])).model
        pred = port_predict.S2ANetPredictor(cfg, weights, "cuda",
                                            port_predict.DTYPES[dtype], SEED)
        pred.divide = True
        thr[(dtype, clamp)] = score_gap(torch, pred, img) if weights else 0.005
        pred.cfg = dataclasses.replace(cfg, score_thr=thr[(dtype, clamp)])
        refs[(dtype, clamp)] = det_lines(torch, scene_dets(torch, pred, img), names)
        del pred
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0", OMP_NUM_THREADS="2")
    env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    env.pop("WORLD_SIZE", None)
    procs = {}
    t0 = time.perf_counter()
    for dtype, clamp, weights in runs:
        save = work / f"b_{dtype}_{clamp:g}"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               str(SPATIAL_RANKS), "-m", "s2anet_tpu_torch.predict", "--mode", "spatial",
               "--source", str(work / "b_src"), "--npy", "--config", str(configs[clamp]),
               "--seed", str(SEED), "--dtype", dtype, "--conf", repr(thr[(dtype, clamp)]),
               "--save-dir", str(save)] + (["--weights", weights] if weights else [])
        say(f"   {' '.join(cmd[2:])}")
        procs[(dtype, clamp)] = (save, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for (dtype, clamp), (save, proc) in procs.items():
        out, err = proc.communicate(timeout=300)
        log = work.parent / f"spatial_torchrun_{dtype}_{clamp:g}.log"
        log.write_text(out + "\n" + err)
        check(proc.returncode == 0, f"17b torchrun {dtype} clamp {clamp:g}: exit "
              f"{proc.returncode} (stderr tail: {err[-600:]!r})")
        summaries = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        s = summaries[0] if len(summaries) == 1 else {}
        got = (save / "scene_b.txt").read_text().splitlines()
        want = refs[(dtype, clamp)]
        with log.open("a") as f:  # both runs' lines, beside the log
            f.write("\n".join(["== one process"] + want + [f"== {SPATIAL_RANKS} ranks"] + got))
        launches = s.get("launches", {})
        check(s.get("mode") == "spatial" and s.get("ranks") == SPATIAL_RANKS
              and "backend gloo" in out and launches.get("s2a_deform_conv2d_fwd") == 5
              and launches.get("s2a_nms_rotated_mask") == 1
              and launches.get("s2a_nms_rotated_sweep") == 1,
              f"17b {dtype} clamp {clamp:g}: one summary from rank 0 of {s.get('ranks')} "
              f"ranks over gloo, rank 0's launches {launches}, model "
              f"{s.get('model_seconds')} s, decode {s.get('decode_seconds')} s")
        if dtype == "float32":
            bad = lines_agree_f32(got, want, names)
            check(not bad and len(want) > 0,
                  f"17b float32 clamp {clamp:g} (score_thr {thr[(dtype, clamp)]:.6f}): {len(got)} "
                  f"detections on {SPATIAL_RANKS} ranks against one process's {len(want)}: "
                  f"valid and labels equal, scores and vertices within rtol 1e-4 / atol 1e-3 "
                  f"(+ the file's rounding) {bad or 'met'}")
        else:
            frac = lines_matched_iou(torch, dev, got, want, names)
            check(frac >= 0.95 and len(want) > 0,
                  f"17b bf16 clamp {clamp:g}, seeded weights, score_thr 0.005: {len(got)} "
                  f"detections on {SPATIAL_RANKS} ranks "
                  f"against one process's {len(want)}, matched 1:1 by (label, score, rotated "
                  f"IoU >= 0.5) {frac:.4f}")
    say(f"   17b: the three torchrun runs together {time.perf_counter() - t0:.1f} s")


def spatial_one_process(torch, dev, scene, wfile: Path, card):
    """Phase 17a: one process, whole scenes (R-50, configs/dota_r50.yaml,
    bf16). Returns the launches of the kernel path's run and the AlignConv
    kernel's times at the scene's levels."""
    import dataclasses

    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch.config import load_config
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import nms_rotated as nms
    from s2anet_tpu_torch.parallel import spatial

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    full = load_config(str(ROOT / "configs" / "dota_r50.yaml"))
    cfg = dataclasses.replace(full.model, score_thr=full.model.predict_score_thr)
    pred = port_predict.S2ANetPredictor(cfg, str(wfile), "cuda", torch.bfloat16, SEED)
    pred.divide = True
    rng = np.random.default_rng(SEED + 18)
    square = rng.integers(0, 90, SQUARE_HW + (3,), dtype=np.uint8)
    draw_objects(rng, square, 300)
    # cuDNN keeps one algorithm a conv shape, found by whichever setting met
    # the shape first, so each setting gets shapes of its own: benchmark off
    # the scene and the square, on the scene turned (the same pixels) and a
    # 4224x3968 (about the square's), the order alternating
    scenes = {"3000x4000": scene, "4096x4096": square,
              "4000x3000": np.ascontiguousarray(scene.transpose(1, 0, 2)),
              "4224x3968": np.ascontiguousarray(square[:, :3968].repeat(2, 0)[:4224])}
    tuning = [("3000x4000", False), ("4000x3000", True), ("4224x3968", True),
              ("4096x4096", False)]

    def spatial_s(name, bench: bool):
        torch.backends.cudnn.benchmark = bench
        timing = {}
        t0 = time.perf_counter()
        _, dets = next(port_predict.serve_spatial(pred, [(name, scenes[name])], timing))
        return time.perf_counter() - t0, timing, len(dets)

    # first scene of a shape new to this process, then 3 repeats
    tune = {}
    for name, bench in tuning:
        first = spatial_s(name, bench)[0]
        again = median_spread([spatial_s(name, bench)[0] for _ in range(3)])
        mp = np.prod(pad_scene(scenes[name]).shape[1:3]) / 1e6
        tune[(name, bench)] = (first, again[0], again[0] / mp)
        say(f"   17a {name} padded {pad_scene(scenes[name]).shape[1:3]}, cudnn.benchmark "
            f"{bench}: first scene {first:.3f} s, repeat {again[0]:.4f} s (median of 3, "
            f"spread {again[1]:.1%}; {1e3 * again[0] / mp:.3f} ms a megapixel)")
    chosen = torch.backends.cudnn.benchmark = port_predict.CUDNN_BENCHMARK["spatial"]
    for bench in (False, True):
        runs = [v for (n, b), v in tune.items() if b == bench]
        say(f"   17a cudnn.benchmark {bench}: first scene over the repeat "
            + ", ".join(f"{f - r:.3f}" for f, r, _ in runs) + " s; repeats "
            + ", ".join(f"{1e3 * m:.3f}" for _, _, m in runs) + " ms a megapixel")
    say(f"   17a: predict --mode spatial sets cudnn.benchmark {chosen}; {card}")
    scenes = {k: scenes[k] for k in ("3000x4000", "4096x4096")}

    # peak memory of a whole scene
    peaks = {}
    for name in scenes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        spatial_s(name, chosen)
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.backends.cudnn.benchmark = True  # chips mode's setting
    torch.cuda.reset_peak_memory_stats(dev)
    next(port_predict.serve_chips(pred, [("scene", scene)], SIZE, 200, BATCH, cfg.nms_iou_thr))
    peaks["chips"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    say("   17a peak memory: " + ", ".join(f"{n} {g:.2f} GiB" for n, g in peaks.items())
        + f" (chips mode, batch {BATCH}: {peaks['chips']:.2f} GiB)")

    # scene seconds, spatial against chips mode in turns (5 each, after a warm-up)
    def chips_s():
        torch.backends.cudnn.benchmark = True
        timing = {}
        t0 = time.perf_counter()
        _, n_windows, dets = next(port_predict.serve_chips(
            pred, [("scene", scene)], SIZE, 200, BATCH, cfg.nms_iou_thr, timing))
        return time.perf_counter() - t0, timing, len(dets)

    runs = {"spatial": lambda: spatial_s("3000x4000", chosen), "chips": chips_s}
    for fn in runs.values():
        fn()
    got = {k: [] for k in runs}
    for _ in range(SPATIAL_TURNS):
        for k, fn in runs.items():
            got[k].append(fn())
    for k, res in got.items():
        wall = median_spread([r[0] for r in res])
        second = "decode" if k == "spatial" else "merge"
        model = median_spread([r[1]["model"] for r in res])
        other = median_spread([r[1][second] for r in res])
        say(f"   17a scene {SCENE_HW[0]}x{SCENE_HW[1]}, {k} mode (bf16, score_thr "
            f"{cfg.score_thr}, {res[0][2]} detections): {wall[0]:.4f} s (median of "
            f"{SPATIAL_TURNS} in turns, spread {wall[1]:.1%}): model {model[0]:.4f} s, "
            f"{second} {other[0]:.4f} s; {card}")
    ratio = median_spread([r[0] for r in got["spatial"]])[0] / median_spread(
        [r[0] for r in got["chips"]])[0]
    say(f"   17a spatial / chips scene seconds: {ratio:.3f} (model pixels 12.58 M against "
        f"20.97 M: 0.600)")

    # the kernel path against the plain path, and the launches of one
    # scene: the seeded weights at score_thr 0.005, as phases 5 and 11
    # hold bf16 (4096 NMS candidates)
    del pred
    torch.backends.cudnn.benchmark = chosen
    pred = port_predict.S2ANetPredictor(dataclasses.replace(full.model, score_thr=0.005), "",
                                        "cuda", torch.bfloat16, SEED)
    pred.divide = True
    img = pad_scene(scene)
    counted = (dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP)
    for k in counted:
        k.launches = 0
    det_k = scene_dets(torch, pred, img)
    launches = {k.symbol: k.launches for k in counted}
    with plain_path(head_mod, dc, nms):
        det_p = scene_dets(torch, pred, img)
    _, by_iou, total = detection_agreement(torch, dev, det_k, det_p)
    check(launches == {"s2a_deform_conv2d_fwd": 5, "s2a_nms_rotated_mask": 1,
                       "s2a_nms_rotated_sweep": 1} and by_iou >= 0.95,
          f"17a scene {img.shape[1]}x{img.shape[2]}, bf16, seeded weights, score_thr 0.005: "
          f"launches {launches}; kernel path against plain path, {total} detections, "
          f"matched 1:1 by (label, score, rotated IoU >= 0.5) {by_iou:.4f}")

    # one rank: the spatial step launches the model's forward as it is
    x = pred.to_input(img)
    with torch.no_grad():
        by_name = [launches_by_name(torch, lambda: spatial.spatial_forward(pred.forward, x)),
                   launches_by_name(torch, lambda: pred.forward(x))]
    check(by_name[0] == by_name[1],
          f"17a one rank: the spatial forward puts on the device what the model's forward "
          f"on the padded scene does, name for name ({sum(by_name[0].values())} launches, "
          f"copies and fills in {len(by_name[0])} names against {sum(by_name[1].values())} "
          f"in {len(by_name[1])})")
    del x

    # the AlignConv kernel at the scene's levels (P3-P7 of 3072x4096, bf16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    levels = []
    for s in cfg.strides:
        h, w = img.shape[1] // s, img.shape[2] // s
        levels.append(((torch.randn(1, h, w, 256, generator=gen, device=dev)).bfloat16(),
                       (torch.randn(1, h, w, 9, 2, generator=gen, device=dev) * 3).bfloat16(),
                       (torch.randn(3, 3, 256, 256, generator=gen, device=dev) * 0.05).bfloat16()))
    t_k, s_k = cuda_ms(torch, lambda: [dc.deform_conv2d_cuda(*a) for a in levels], 10)
    nbytes = ops = 0
    for xl, _, wl in levels:
        cells = xl.numel() // 256
        nbytes += cells * (2 * 256 + 18 * 4 + 2 * 256) + 9 * 256 * 256 * 2
        ops += 2 * cells * 9 * 256 * 256
    b = bound(nbytes, ops, BF16_FLOP_S)
    per = []
    for xl, ol, wl in levels:
        t_l, _ = cuda_ms(torch, lambda xl=xl, ol=ol, wl=wl: dc.deform_conv2d_cuda(xl, ol, wl), 10)
        per.append(f"{tuple(xl.shape[1:3])} {t_l:.4f}")
    say(f"   17a deform_conv2d at the scene's P3-P7 (bf16): {t_k:.3f} ms (spread {s_k:.1%}), "
        f"bound {b[0]:.3f} ms ({b[1]}): {b[0] / t_k:.1%}; per level ms: {', '.join(per)}; "
        f"{card}")
    del pred, levels
    torch.cuda.empty_cache()
    return launches, {"spatial_ms": t_k, "spatial_bound_ms": b[0]}


def phase_spatial(torch, dev, out_dir, scene=None):
    """Section 17 of the module docstring; ``scene`` is phase 11's (made
    again from its generator when None). Returns the launches of a spatial
    scene and the AlignConv's times at its levels."""
    say("== 17. spatial serving")
    card = card_line()
    work = out_dir / "spatial"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if scene is None:
        scene = write_eval_data(work / "eval", np.random.default_rng(SEED), 16, SCENE_HW)
        shutil.rmtree(work / "eval", ignore_errors=True)
    from s2anet_tpu_torch.config import load_config

    full = load_config(str(ROOT / "configs" / "dota_r50.yaml"))
    wfile = work / "weights.pt"
    scale = spatial_weights(torch, dev, full.model, wfile)
    say(f"   weights: seed {SEED}, the ODM class head's kernel times {scale:.1f} (a share "
        f"{ODM_PASS:g} of a scene-like 1024^2 image's scores above 0.3)")
    t0 = time.perf_counter()
    spatial_cli_runs(torch, dev, work, wfile, full.data.names)
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    halo_err = spatial_halo_card(torch, dev, gen, card)
    t2 = time.perf_counter()
    launches, times = spatial_one_process(torch, dev, scene, wfile, card)
    say(f"   phase 17: b {t1 - t0:.1f} s, c {t2 - t1:.1f} s, a {time.perf_counter() - t2:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return launches, dict(times, spatial_halo_max_abs_err=halo_err)


IMAGE_HW = (1500, 2000)  # phase 18: the scenes' height and width
IMAGE_RATES = (0.5, 1.0)  # phase 18: prepare_dota's rates


def image_scene(rng, png: Path, label: Path):
    """A DOTA-layout scene (RGB noise with filled rotated rectangles) as a
    PNG that uses the five row filters in turn, and its ``labelTxt`` (a
    seventh of the objects difficult); returns the RGB pixels."""
    from s2anet_tpu_torch.config import DOTA10_CLASSES
    from s2anet_tpu_torch.data.synth import write_png
    from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np

    img = rng.integers(0, 90, IMAGE_HW + (3,), dtype=np.uint8)
    boxes, classes = draw_objects(rng, img, 60)
    write_png(png, img, filters=np.arange(IMAGE_HW[0]) % 5)
    polys = rbox_vertices_np(boxes).reshape(-1, 8)
    label.write_text("imagesource:synthetic\ngsd:0.5\n" + "".join(
        " ".join(f"{v:.1f}" for v in p) + f" {DOTA10_CLASSES[c]} {int(i % 7 == 0)}\n"
        for i, (c, p) in enumerate(zip(classes, polys))))
    return img


def phase_images(torch, dev, out_dir, keep_files: bool = False):
    """Section 18 of the module docstring. Returns the launches of a
    ``predict`` batch on image files. With ``keep_files`` its files stay under
    ``out_dir/images`` (phase 19 draws on its chips); the caller removes
    them."""
    say("== 18. image files")
    import zlib

    from s2anet_tpu_torch import native
    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.data import image as image_mod
    from s2anet_tpu_torch.data import split
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import nms_rotated as nms

    card = card_line()
    work = out_dir / "images"
    shutil.rmtree(work, ignore_errors=True)
    src, scenes = work / "src", work / "scenes"
    scenes.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 18)
    rgbs = {}
    for k, s in enumerate(("train", "val")):
        (src / s / "images").mkdir(parents=True)
        (src / s / "labelTxt").mkdir()
        png = src / s / "images" / f"P{k:04d}.png"
        rgbs[png.stem] = image_scene(rng, png, src / s / "labelTxt" / f"P{k:04d}.txt")
        shutil.copyfile(png, scenes / png.name)

    # the reader: the scene's pixels back, and its rate with the C++ unfilter
    png = scenes / "P0000.png"
    data = png.read_bytes()
    (w, h, _, _), _, raw, row_bytes, bpp = image_mod.png_stream(data)
    filters = set(raw.reshape(h, row_bytes + 1)[:, 0].tolist())
    idat, _ = image_mod.png_chunks(data)
    t_read, t_inflate, t_unfilter = [], [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        got = image_mod.imread(png)
        t1 = time.perf_counter()
        zlib.decompress(idat)
        t2 = time.perf_counter()
        native.png_unfilter(raw, h, row_bytes, bpp)
        t_read.append(t1 - t0)
        t_inflate.append(t2 - t1)
        t_unfilter.append(time.perf_counter() - t2)
    mb = h * w * 3 / 1e6
    rates = {name: mb / float(np.median(t)) for name, t in
             (("read", t_read), ("inflate", t_inflate), ("unfilter", t_unfilter))}
    check(native.AVAILABLE and filters == {0, 1, 2, 3, 4}
          and np.array_equal(got[:, :, ::-1], rgbs["P0000"]),
          f"data/image.py reads the {h}x{w} scene (row filters {sorted(filters)}) to its "
          f"pixels: {rates['read']:.1f} MB/s of pixels (C++ unfilter alone "
          f"{rates['unfilter']:.1f} MB/s, zlib inflate alone {rates['inflate']:.1f} MB/s; "
          f"median of {REPEATS}, host)")

    # prepare_dota: split at the rates (a process pool), convert, list
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "s2anet_tpu_torch.tools.prepare_dota", "--src", str(src),
         "--out", str(work / "prep"), "--subsize", str(SIZE), "--gap", "200",
         "--rates", *map(str, IMAGE_RATES), "--workers", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    t_prep = time.perf_counter() - t0
    check(proc.returncode == 0, f"prepare_dota: exit {proc.returncode} "
          f"(stderr tail: {proc.stderr[-600:]!r})")
    want = sum(len(split.window_origins(int(round(IMAGE_HW[0] * r)), int(round(IMAGE_HW[1] * r)),
                                        SIZE, SIZE - 200)) for r in IMAGE_RATES)
    for s in ("train", "val"):
        d = work / "prep" / f"{s}_split"
        chips = sorted(p.name for p in (d / "images").iterdir())
        labels = sorted(p.name for p in (d / "labels").iterdir())
        check(len(chips) == want and f"{s}: {want} chips" in proc.stdout
              and not any(c.endswith(".npy") for c in chips)
              and (s == "train" or len(labels) == want),
              f"prepare_dota --rates {' '.join(map(str, IMAGE_RATES))}: {s} {len(chips)} PNG "
              f"chips (window_origins: {want}), {len(labels)} label files, no sidecar")
    split_s = {}
    for r in IMAGE_RATES:
        tmp = work / f"split_{r}"
        (tmp / "images").mkdir(parents=True)
        (tmp / "labelTxt").mkdir()
        t0 = time.perf_counter()
        n = split._split_one((png, src / "train" / "labelTxt" / "P0000.txt", tmp / "images",
                              tmp / "labelTxt", SIZE, 200, r, 0.5, ".png"))
        split_s[r] = time.perf_counter() - t0
        shutil.rmtree(tmp)
    say(f"   split of one {h}x{w} scene, one process: " + ", ".join(
        f"rate {r}: {t:.2f} s" for r, t in split_s.items())
        + f"; prepare_dota (2 scenes x {len(IMAGE_RATES)} rates, 4 workers, "
        f"process start included) {t_prep:.2f} s")

    # val on the val list: every chip decoded by data/image.py
    decoded = []
    real_read = image_mod.read_png

    def read_png(data, name="PNG"):
        decoded.append(Path(name).name)
        return real_read(data, name)

    listed = [Path(x).name for x in
              (work / "prep" / "val_split.txt").read_text().splitlines()]
    with mock.patch.object(image_mod, "read_png", read_png):
        res = port_val.main(["--data-root", str(work / "prep" / "val_split.txt"),
                             "--batch-size", str(BATCH), "--img-size", str(SIZE),
                             "--save-dir", str(work / "val")])
    check(res["n_images"] == len(listed) == want and sorted(set(decoded)) == sorted(listed),
          f"val on val_split.txt: {res['n_images']} chips, each read by data/image.py "
          f"({len(decoded)} decodes), map50 {res['map50']:.4f} (random weights)")

    # predict on the PNG scenes (--save-img) and with --npy on their RGB pixels
    (work / "npy").mkdir()
    for name, rgb in rgbs.items():
        np.save(work / "npy" / f"{name}.npy", rgb)
    kernels = (dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP)
    common = ["--batch-size", str(BATCH), "--conf", "0.005", "--seed", str(SEED)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    s_png = port_predict.main(["--source", str(scenes), "--save-img",
                               "--save-dir", str(work / "pred_png"), *common])
    t_png = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    s_npy = port_predict.main(["--source", str(work / "npy"), "--npy",
                               "--save-dir", str(work / "pred_npy"), *common])
    torch.backends.cudnn.deterministic = deterministic
    batches = -(-s_png["chips"] // BATCH)
    per_batch = {sym: n / batches for sym, n in launches.items()}
    check(per_batch == {"s2a_deform_conv2d_fwd": 5, "s2a_nms_rotated_mask": 1,
                        "s2a_nms_rotated_sweep": 1},
          f"predict on {s_png['images']} PNG scenes: {s_png['chips']} windows in {batches} "
          f"batches, launches {launches} ({per_batch} a batch)")
    same = all((work / "pred_png" / f"{n}.txt").read_bytes()
               == (work / "pred_npy" / f"{n}.txt").read_bytes() for n in rgbs)
    task1 = sorted((work / "pred_png" / "dota_submission").glob("Task1_*.txt"))
    n_task1 = sum(len(f.read_text().splitlines()) for f in task1)
    same_task1 = all(f.read_bytes() == (work / "pred_npy" / "dota_submission" / f.name)
                     .read_bytes() for f in task1)
    check(same and same_task1 and len(task1) == 15 and n_task1 == s_png["detections"] > 0,
          f"predict: {s_png['detections']} detections, each scene's lines and the 15 Task1 "
          f"files byte-equal to --npy on the same RGB pixels ({s_npy['detections']}); "
          f"{t_png:.1f} s with --save-img (model {s_png['model_seconds']:.3f} s, merge "
          f"{s_png['merge_seconds']:.3f} s)")
    drawn = {n: image_mod.imread(work / "pred_png" / f"{n}.png") for n in rgbs}
    check(all(d.shape == IMAGE_HW + (3,) and (d[:, :, ::-1] != rgbs[n]).any()
              for n, d in drawn.items()),
          f"--save-img: {len(drawn)} PNGs decode at {IMAGE_HW[0]}x{IMAGE_HW[1]}, boxes drawn")

    # the single-class entry points on the card against the plain keep
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    boxes, labels, valid = (t[0] for t in clustered_candidates(torch, gen, 1, 4096, dev))
    scores = torch.randint(0, 20, (4096,), generator=gen, device=dev).float() / 20  # ties
    scattered = torch.rand(4096, generator=gen, device=dev) < 0.7
    for vname, v in (("all", None), ("70%", scattered), ("none", torch.zeros_like(valid))):
        for fname, fn in (("nms_rotated", lambda v: nms.nms_rotated(boxes, scores, 0.5, v)),
                          ("ml_nms_rotated",
                           lambda v: nms.ml_nms_rotated(boxes, scores, labels, 0.5, v))):
            before = [k.launches for k in kernels[1:]]
            keep = fn(v)
            torch.cuda.synchronize()
            once = [k.launches - b for k, b in zip(kernels[1:], before)] == [1, 1]
            with mock.patch.object(nms, "nms_keep", nms.nms_keep_plain):
                ref = fn(v)
            check(once and torch.equal(keep, ref) and keep.is_cuda,
                  f"{fname}, 4096 clustered candidates, valid {vname}: keeps equal to the "
                  f"plain keep's ({int(keep.sum())} kept), mask and sweep launched once")
    say(f"   phase 18 numbers beside {card}")
    if not keep_files:
        shutil.rmtree(work, ignore_errors=True)
    return per_batch


# phase 19: a child process that reloads the exported program with the
# port's custom ops and nothing else of the package and serves one batch
# (argv: program, its input, the uint8 batch, the outputs, TF32 in cuDNN,
# seed); then, the modules it needed recorded, the eager predictor on the
# same batch in the same fresh process. cuDNN never autotunes there, so
# both meet the same convolution algorithms: a process that has autotuned
# a shape keeps the algorithms it found for it, even with autotuning off
EXPORT_CHILD = """
import json, sys
import numpy as np
import torch
import s2anet_tpu_torch.ops.library  # noqa: F401  (the s2anet ops)
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.allow_tf32 = sys.argv[5] == "1"
program = torch.export.load(sys.argv[1]).module()
out = program(torch.from_numpy(np.load(sys.argv[2])).cuda())
modules = sorted(m for m in sys.modules if m.startswith("s2anet_tpu"))
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.predict import S2ANetPredictor
pred = S2ANetPredictor(ModelConfig(score_thr=0.005), device="cuda", dtype=torch.bfloat16,
                       seed=int(sys.argv[6]))
eager = pred.predict(np.load(sys.argv[3]))
np.savez(sys.argv[4], *[t.cpu().numpy() for t in (*out, *eager)])
print(json.dumps(modules))
"""


def device_kernels(torch, fn):
    """``Counter`` of the device's kernels (and copies) by name over one
    call of ``fn``, from the profiler."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter({e.key: e.count for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA and e.count})


def batches_per_s(torch, fn, n: int = 3) -> float:
    """Chips/s of ``n`` batches of ``fn``, host clock to the device's end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return n * BATCH / (time.perf_counter() - t0)


def report_against_profiler(torch, profiler, profile_report, trace_dir: Path, fn, what):
    """Run ``fn`` once under ``utils/profiler.trace`` and hold the report's
    device total within 1% of the profiler's own ``key_averages()``."""
    from torch.autograd import DeviceType

    with profiler.trace(trace_dir, what.replace(" ", "_")) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
    avg = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    # the ranges of the step marker and of record_function annotations
    # (the optimizer's step) on the device's timeline are no kernels
    own = sum(getattr(e, key) for e in avg if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("ProfilerStep")) / 1000
    rep = profile_report.report(trace_dir)
    check(rep["steps"] == 1 and abs(rep["total_ms"] - own) <= 0.01 * own,
          f"profile_report on a {what}: {rep['total_ms']:.3f} ms of device time in "
          f"{sum(n for _, n, _ in rep['kernels'].values())} launches, key_averages() "
          f"{own:.3f} ms (within 1%)")
    for line in profile_report.format_report(rep, top=15).splitlines():
        if line and not line.startswith("trace"):
            say(f"     {line}")
    return rep


def phase_export(torch, dev, out_dir, chips_s: float, parent=None):
    """Section 19 of the module docstring. Returns the launches a batch of
    the reloaded exported program."""
    say("== 19. export and tools")
    t_phase = time.perf_counter()
    laps = []

    def lap(what: str) -> None:
        laps.append((what, time.perf_counter()))
    from s2anet_tpu_torch import export as port_export
    from s2anet_tpu_torch.config import ModelConfig
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import nms_rotated as nms
    from s2anet_tpu_torch.predict import S2ANetPredictor
    from s2anet_tpu_torch.tools import profile_report, quant_scope_bench, visualize
    from s2anet_tpu_torch.train import __main__ as train_cli
    from s2anet_tpu_torch.train.step import INV255, train_step
    from s2anet_tpu_torch.utils import flops, profiler

    card = card_line()
    work = out_dir / "export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    kernels = (dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP)
    # autotuning off for the comparisons: every process picks the same
    # convolution algorithms
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    cfg = ModelConfig(score_thr=0.005)  # 4096 valid NMS candidates an image
    pred = S2ANetPredictor(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    serving = port_export.serving_module(pred)
    t0 = time.perf_counter()
    program = port_export.export_serving(serving, BATCH, SIZE, dev)
    t_export = time.perf_counter() - t0
    path = work / "s2anet.pt2"
    torch.export.save(program, path)
    ops = {str(n.target): 0 for n in program.graph.nodes if str(n.target).startswith("s2anet.")}
    for n in program.graph.nodes:
        if str(n.target) in ops:
            ops[str(n.target)] += 1
    check(ops == {"s2anet.s2a_deform_conv2d_fwd.default": 5,
                  "s2anet.s2a_nms_rotated_mask.default": 1,
                  "s2anet.s2a_nms_rotated_sweep.default": 1},
          f"torch.export of R-50 {SIZE}^2 bf16 batch {BATCH} (score_thr 0.005) on the card in "
          f"{t_export:.1f} s, {path.stat().st_size / 1e6:.1f} MB; the graph's s2anet ops {ops}")
    lap("export")

    imgs = np.random.default_rng(SEED + 19).integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                                     dtype=np.uint8)
    x = torch.from_numpy(imgs).to(dev).float().mul_(INV255)  # predict's own scaling
    want = pred.predict(imgs)
    t0 = time.perf_counter()
    loaded = torch.export.load(path).module()
    t_load = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    got = loaded(x)
    torch.cuda.synchronize()
    per_batch = {k.symbol: k.launches for k in kernels}
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    check(same and per_batch == {"s2a_deform_conv2d_fwd": 5, "s2a_nms_rotated_mask": 1,
                                 "s2a_nms_rotated_sweep": 1} and int(want[2].sum()) > 0,
          f"reloaded in {t_load:.1f} s: bit-equal to S2ANetPredictor.predict on the same "
          f"batch ({int(want[2].sum())} detections); launches {per_batch}")
    np.save(work / "x.npy", x.cpu().numpy())
    np.save(work / "imgs.npy", imgs)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", EXPORT_CHILD, str(path), str(work / "x.npy"),
                          str(work / "imgs.npy"), str(work / "out.npz"),
                          str(int(torch.backends.cudnn.allow_tf32)), str(SEED)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    t_child = time.perf_counter() - t0
    if res.returncode:
        check(False, f"child process: rc {res.returncode}: {res.stderr[-2000:]}")
    modules = json.loads(res.stdout.strip().splitlines()[-1])
    child = np.load(work / "out.npz")
    child_out = [child[f"arr_{i}"] for i in range(3)]
    child_eager = [child[f"arr_{i}"] for i in range(3, 6)]
    child_same = all(np.array_equal(a, b) for a, b in zip(child_out, child_eager))
    # against this process's eager batch, whose convolutions phases 5-18
    # autotuned: other algorithms, other bf16 roundings
    _, by_iou, total = detection_agreement(torch, dev, child_out,
                                           [t.cpu().numpy() for t in want])
    check(child_same and "s2anet_tpu_torch.ops.library" in modules
          and not [m for m in modules if m.startswith("s2anet_tpu_torch.models")],
          f"a child process importing only s2anet_tpu_torch.ops.library ({len(modules)} "
          f"s2anet_tpu_torch modules, none of models/) and cuDNN never autotuning: the "
          f"reloaded program bit-equal to the eager predictor in that process "
          f"({int(child_out[2].sum())} detections); against this process's eager batch "
          f"matched 1:1 by IoU {by_iou:.4f} of {total}; {t_child:.1f} s with its start")
    lap("reloads")
    eager_k = device_kernels(torch, lambda: serving(x))
    export_k = device_kernels(torch, lambda: loaded(x))
    hand = {n: c for n, c in export_k.items()
            if any(h in n for h in ("deform_fwd", "nms_mask_kernel", "nms_sweep_kernel"))}
    extra = sum(export_k.values()) - sum(eager_k.values())
    # the program holds the head's cached anchor grids as constants, so it
    # launches what the eager module does. A plain AlignConv adds hundreds
    # of launches a level, the plain sweep thousands
    check(sorted(hand.values()) == [1, 1, 5] and abs(extra) <= 10,
          f"profiled batch of the reloaded program: {sum(export_k.values())} launches, "
          f"the hand kernels {dict((n[:40], c) for n, c in hand.items())}; the eager module "
          f"{sum(eager_k.values())} launches ({extra:+d}, bar 10)")

    # eager against exported, in turns, autotuning on (serving's setting)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False
    for fn in (lambda: serving(x), lambda: loaded(x)):
        fn()
    rates = {"eager": [], "exported": []}
    for _ in range(REPEATS):
        for name, fn in (("eager", lambda: serving(x)), ("exported", lambda: loaded(x))):
            rates[name].append(batches_per_s(torch, fn))
    say("   serving module at score_thr 0.005 on a device batch, in turns (median of "
        f"{REPEATS} x 3 batches): " + "; ".join(
            f"{name} {median_spread(r)[0]:.2f} chips/s (spread {median_spread(r)[1]:.1%}, "
            f"runs {', '.join(f'{v:.2f}' for v in r)})" for name, r in rates.items())
        + f"; {card}")
    lap("profiles and timing")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loaded(x)
        torch.cuda.synchronize()
    (work.parent / "chip_smoke_export_profile.txt").write_text(
        f"{card}\n{prof.key_averages().table(sort_by='self_cpu_time_total', row_limit=40)}\n")
    if parent is not None:
        import importlib

        load_parent(parent)
        ppredict = importlib.import_module(PARENT_PKG + ".predict")
        pconfig = importlib.import_module(PARENT_PKG + ".config")
        ppred = ppredict.S2ANetPredictor(pconfig.ModelConfig(), device="cuda",
                                         dtype=torch.bfloat16, seed=SEED)
        npred = S2ANetPredictor(ModelConfig(), device="cuda", dtype=torch.bfloat16, seed=SEED)
        for p in (npred, ppred, npred):
            p.predict(imgs)
        turns = {"this tree": [], "parent": []}
        for r in range(REPEATS):
            order = ("this tree", "parent") if r % 2 == 0 else ("parent", "this tree")
            for name in order:
                p = npred if name == "this tree" else ppred
                turns[name].append(batches_per_s(torch, lambda p=p: p.predict(imgs)[0].sum().item()))
        say("   eager serving, predict() at score_thr 0.05 as phase 6, in turns with --parent "
            f"(median of {REPEATS} x 3 batches): " + "; ".join(
                f"{name} {median_spread(r)[0]:.2f} chips/s (spread {median_spread(r)[1]:.1%}, "
                f"runs {', '.join(f'{v:.2f}' for v in r)})" for name, r in turns.items())
            + f"; {card}")
        del ppred, npred
        lap("--parent")

    # the analytic FLOPs of the program, the measured matmul peak, the share
    dce = flops.count_program_flops(program, dce=True) / BATCH
    executed = flops.count_program_flops(program, dce=False) / BATCH
    peak = flops.measure_matmul_peak(torch.bfloat16)
    say(f"   FLOPs (utils/flops.py on the exported graph): {dce / 1e9:.3f} GFLOP/chip after "
        f"dead-code removal, {executed / 1e9:.3f} as the eager port executes them (the FAM "
        f"classification branch {100 * (executed - dce) / executed:.1f}%); measured bf16 "
        f"matmul peak {peak / 1e12:.1f} TFLOP/s (4096^3 torch.mm, differenced chains); "
        f"model-FLOP share at phase 6's {chips_s:.2f} chips/s: "
        f"{100 * flops.mfu(dce, chips_s, peak):.2f}% of the measured peak, "
        f"{100 * flops.mfu(dce, chips_s, BF16_FLOP_S):.2f}% of 989 TFLOP/s; {card}")
    del program, loaded
    lap("FLOPs and peak")

    # profile_report on a serving batch and on a train step
    report_against_profiler(torch, profiler, profile_report, work / "trace_serve",
                            lambda: pred.predict(imgs)[0].sum().item(), "serving batch")
    del pred, serving
    args = ["--backbone", "resnet50", "--img-size", str(SIZE), "--batch-size", str(BATCH),
            "--dtype", "bfloat16", "--clamp", "6.0", "--seed", str(SEED)]
    tcfg, model, optimizer, ema, batches = train_cli.setup(train_cli.parse_opt(args))
    for i in range(2):
        train_step(model, optimizer, ema, batches[i % len(batches)], tcfg).tolist()
    report_against_profiler(torch, profiler, profile_report, work / "trace_train",
                            lambda: train_step(model, optimizer, ema, batches[0], tcfg).tolist(),
                            "train step")
    del model, optimizer, ema, batches
    torch.cuda.empty_cache()
    lap("profile_report")

    say("   python -m s2anet_tpu_torch.tools.quant_scope_bench --reps 2")
    rows = quant_scope_bench.main(["--reps", "2"])
    scoped = {r["scope"]: r for r in rows}
    check(len(rows) == 1 + len(quant_scope_bench.DEFAULT_SCOPES)
          and scoped["backbone,neck,head_stacks"]["conv_launches"] == 100
          and scoped["backbone,neck,head_stacks,orconv,heads"]["conv_launches"] == 125
          and all(r["chips_per_s"] > 0 for r in rows),
          f"quant_scope_bench: float and {len(rows) - 1} scopes, int8 convs a batch "
          + ", ".join(f"{r['scope']} {r['conv_launches']}" for r in rows))
    torch.cuda.empty_cache()
    lap("quant_scope_bench")

    vis = work / "visual"
    wfile = work / "w.pt"
    # one chip at a time: shapes of their own, not worth autotuning
    torch.backends.cudnn.benchmark = False
    spatial_weights(torch, dev, ModelConfig(), wfile)
    drawn = visualize.main(["--data-root", str(out_dir / "images" / "prep" / "val_split.txt"),
                            "--out-dir", str(vis), "--weights", str(wfile), "--num", "4",
                            "--img-size", str(SIZE), "--conf", "0.3"])
    from s2anet_tpu_torch.data import image as image_mod

    pngs = [image_mod.imread(p) for p in drawn]
    check(len(pngs) == 4 and all(p.shape == (SIZE, SIZE, 3) for p in pngs),
          f"visualize on phase 18's val chips: {len(pngs)} PNGs of {SIZE}x{SIZE} in {vis.name}/")
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False
    lap("visualize")
    prev = t_phase
    parts = []
    for what, t in laps:
        parts.append(f"{what} {t - prev:.1f}")
        prev = t
    say(f"   phase 19 in {time.perf_counter() - t_phase:.1f} s ({', '.join(parts)}); {card}")
    return per_batch


PAN_BF16_TOL = 2e-2  # phase 20: a bf16 PAN level against float32, of its largest magnitude


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (float32)."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_pan(torch, dev):
    """Section 20 of the module docstring. Returns the launches a serving
    batch with the PAN neck (float and int8) and the int8 rows' PAN
    numbers."""
    import copy

    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch.config import ModelConfig
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.models.detector import S2ANet
    from s2anet_tpu_torch.models.fpn import PAN
    from s2anet_tpu_torch.models.resnet import stage_channels
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import nms_rotated as nms
    from s2anet_tpu_torch.ops import quant as pq

    say("== 20. PAN neck")
    t_phase = time.perf_counter()
    card = card_line()
    say(f"   card: {card}")
    torch.backends.cudnn.benchmark = True
    build = S2ANet.from_config

    def pan_detector(mc):
        """The detector with its neck a PAN, seeded as the rest."""
        model = build(mc)
        model.neck = PAN(stage_channels(mc.backbone), 256, len(mc.strides))
        return model

    with mock.patch.object(S2ANet, "from_config", pan_detector):
        pred = port_predict.S2ANetPredictor(ModelConfig(), device="cuda", seed=SEED)
        qpred = port_predict.S2ANetPredictor(ModelConfig(quant="int8", quant_scope="neck"),
                                             device="cuda", seed=SEED)
    fpn_pred = port_predict.S2ANetPredictor(ModelConfig(), device="cuda", seed=SEED)
    check(isinstance(pred.model.neck, PAN) and isinstance(qpred.model.neck, PAN),
          "R-50 1024^2 bf16 serving with the neck PAN((512, 1024, 2048), 256, 5) (folded BN, "
          "seeded weights; lecun_normal PAN convs), and the same in int8 (neck scope)")
    rng = np.random.default_rng(SEED + 20)
    batches = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(5)]
    imgs = batches[0]

    # a: the PAN alone in bf16 against its own weights in float32
    with torch.no_grad():
        feats = pred.model.backbone(pred.to_input(imgs))
        pan = pred.model.neck
        pan32 = copy.deepcopy(pan).float()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        out32 = pan32([f.float() for f in feats])
        torch.backends.cudnn.allow_tf32 = tf32
        out16 = pan(feats)
    errs = [rel_err(a, b) for a, b in zip(out16, out32)]
    check(max(errs) <= PAN_BF16_TOL and all(torch.isfinite(o).all().item() for o in out16)
          and [tuple(o.shape[2:]) for o in out16] == [(128, 128), (64, 64), (32, 32), (16, 16),
                                                     (8, 8)],
          f"PAN on C3-C5 of R-50 over 8 seeded 1024^2 chips: bf16 channels-last against "
          f"the same weights in float32 (TF32 off), max |diff| / max |f32| per level P3-P7 "
          + ", ".join(f"{e:.2e}" for e in errs) + f" (bound {PAN_BF16_TOL})")
    with torch.no_grad():
        (t_pan, s_pan), (t_fpn, s_fpn) = paired_ms(torch, lambda: pan(feats),
                                                   lambda: pan.fpn(feats), 5)
        # each count the larger of two profiles: in one whole run the
        # first profile after phase 19's scheduled traces recorded nothing
        l_pan = max(device_launches(torch, lambda: pan(feats)) for _ in range(2))
        l_fpn = max(device_launches(torch, lambda: pan.fpn(feats)) for _ in range(2))
    check(l_pan > l_fpn > 0,
          f"neck a batch, in turns: PAN {t_pan:.3f} ms (spread {s_pan:.1%}), {l_pan} launches; "
          f"its FPN alone {t_fpn:.3f} ms (spread {s_fpn:.1%}), {l_fpn} launches; {card}")
    del feats, pan32, out32, out16

    # b: serving behind the PAN, kernel path against plain path
    kernels = (dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP)
    pred.predict(imgs, score_thr=0.005)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    det_k = [t.cpu().numpy() for t in pred.predict(imgs, score_thr=0.005)]
    per_batch = {k.symbol: k.launches for k in kernels}
    with plain_path(head_mod, dc, nms):
        det_p = [t.cpu().numpy() for t in pred.predict(imgs, score_thr=0.005)]
    centre, by_iou, total = detection_agreement(torch, dev, det_k, det_p)
    check(by_iou >= 0.95 and per_batch == {"s2a_deform_conv2d_fwd": 5,
                                           "s2a_nms_rotated_mask": 1,
                                           "s2a_nms_rotated_sweep": 1},
          f"serving with the PAN neck at score_thr 0.005: kernel path against plain path "
          f"{by_iou:.1%} matched 1:1 by rotated IoU >= 0.5 ({centre:.1%} by centre) of {total} "
          f"detections; launches a batch {per_batch}")
    rates = {"PAN": [], "FPN": []}
    for p in (pred, fpn_pred):
        p.predict(imgs)
    for _ in range(3):
        for name, p in (("PAN", pred), ("FPN", fpn_pred)):
            rates[name].append(batches_per_s(torch, lambda p=p: p.predict(imgs)[0].sum().item(), 3))
    say("   chips/s at score_thr 0.05 (3 runs of 3 batches in turns): " + "; ".join(
        f"{name} neck {rate_spread(r)}" for name, r in rates.items()) + f"; {card}")
    del fpn_pred

    # c: int8, neck scope, calibrated on 4 batches
    ranges = qpred.calibrate(batches[1:])
    check(len(ranges) == 14 and all(n.startswith("neck.") for n in ranges),
          f"int8 PAN calibrated on 4 batches: {len(ranges)} quantised convs (3 laterals, "
          f"5 output convs, 2 bottom-up, 4 PAN output)")
    qkernels = (pq.QUANTIZE, pq.CONV, dc.DEFORM_FWD)
    qpred.predict(imgs)
    torch.cuda.synchronize()
    for k in qkernels:
        k.launches = 0
    qpred.predict(imgs)
    torch.cuda.synchronize()
    q_batch = {k.symbol: k.launches for k in qkernels}
    check(q_batch == {"s2a_quantize_act": 14, "s2a_int8_conv2d": 14,
                      "s2a_deform_conv2d_fwd": 5},
          f"int8 PAN launches a serving batch {q_batch}")
    x = qpred.to_input(imgs)
    convs, quants = record_int8(pq, lambda: qpred.forward(x))
    n_eq = sum(torch.equal(pq.int8_conv2d_cuda(*a), pq.int8_conv2d_plain(*a))
               for _, a in convs.values())
    q_eq = sum(torch.equal(pq.quantize_act_cuda(*a), pq.quantize_act_plain(*a))
               for _, a in quants.values())
    check(n_eq == len(convs) and q_eq == len(quants),
          f"int8 PAN: s2a_int8_conv2d == int8_conv2d_plain bit for bit on {n_eq} of "
          f"{len(convs)} distinct conv shapes, s2a_quantize_act == quantize_act_plain on "
          f"{q_eq} of {len(quants)} activation shapes")
    conv_ms = conv_bound = conv_plain = q_ms = q_bound = 0.0
    for key, (n, args) in sorted(convs.items()):
        xq, wq, _, _, _, stride, pad, dtype, _ = args
        b, h, w, cin, cout, k = key[:6]
        ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        m = b * ho * wo
        t_k, sp = cuda_ms(torch, lambda a=args: pq.int8_conv2d_cuda(*a), 10)
        t_p, _ = cuda_ms(torch, lambda a=args: pq.int8_conv2d_plain(*a), 1, repeats=1)
        bd = bound(xq.numel() + wq.numel() + m * cout * dtype.itemsize + 12 * cout,
                   2.0 * m * cout * k * k * cin, INT8_OPS_S)
        plan = pq._plan(dev, xq.shape, wq.shape, stride, pad, dtype)[0]
        say(f"     int8 conv {key[:8]} x{n}: {t_k:.4f} ms (spread {sp:.1%}), bound "
            f"{bd[0]:.4f} ms ({bd[1]}), {bd[0] / t_k:.1%}; plain {t_p:.3f} ms; plan bn "
            f"{plan.bn} amode {plan.amode} kb {plan.kb} splits {plan.splits}")
        conv_ms, conv_bound, conv_plain = (conv_ms + n * t_k, conv_bound + n * bd[0],
                                           conv_plain + n * t_p)
    for key, (n, args) in quants.items():
        t_q, _ = cuda_ms(torch, lambda a=args: pq.quantize_act_cuda(*a), 10)
        q_ms += n * t_q
        q_bound += n * bound(args[0].numel() * (args[0].element_size() + 1), 0, INT8_OPS_S)[0]
    say(f"   int8 PAN convs, a batch ({sum(n for n, _ in convs.values())} calls): "
        f"{conv_ms:.3f} ms, bound {conv_bound:.3f} ms: {conv_bound / conv_ms:.1%} of it (bytes "
        f"/ 3.35 TB/s or operations / 1,979 TOPS), plain {conv_plain:.1f} ms; quantiser "
        f"{q_ms:.3f} ms, bound {q_bound:.3f} ms ({q_bound / q_ms:.1%}); {card}")
    del pred, qpred, convs, quants, x
    torch.cuda.empty_cache()
    say(f"   phase 20 in {time.perf_counter() - t_phase:.1f} s; {card}")
    return dict(per_batch, **{f"int8 {k}": v for k, v in q_batch.items()
                              if k != "s2a_deform_conv2d_fwd"},
                conv=dict(ms=conv_ms, bound_ms=conv_bound, plain_ms=conv_plain),
                quantize=dict(ms=q_ms, bound_ms=q_bound))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU")
    parser.add_argument("--out", default=str(ROOT / "runs" / "chip_smoke"),
                        help="directory for the predictions and the profile table")
    parser.add_argument("--parent", default=None,
                        help="a checkout of an earlier tree: phase 13 times its int8 conv "
                             "in turns with this one, phase 16 its train steps (one process "
                             "and data parallel) and profiles a step of each")
    opts = parser.parse_args(argv)
    out_dir = Path(opts.out)
    parent = Path(opts.parent).resolve() if opts.parent else None

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "s2anet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no s2anet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1

    from s2anet_tpu_torch import _ext
    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch.config import ModelConfig
    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.models.anchors import grid_anchors
    from s2anet_tpu_torch.models.head import decode_levels
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import iou_rotated as iou
    from s2anet_tpu_torch.ops import nms_rotated as nms
    from s2anet_tpu_torch.ops import topk

    dev = torch.device("cuda", 0)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = card_line()

    say("== 1. card")
    say(f"   card: {card}")
    say(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"capability {torch.cuda.get_device_capability(0)}")

    say("== 2. build")
    libs = ("deform_conv", "iou_nms_rotated", "bn_moments", "int8_conv")
    t0 = time.perf_counter()
    _ext.build(libs)
    say(f"   {len(libs)} libraries in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name in libs:
        secs, log = _ext.build_log.get(name, (0.0, ""))
        say(f"   {name}: built in {secs:.1f} s")
        for line in log.splitlines():
            if "Compiling entry" in line:
                say(f"     {line.strip().split('_cu_')[-1][:60]}")
            if "Used" in line or "spill" in line or "arning" in line:
                say(f"       {line.strip()}")

    # f32 comparisons: no TF32 anywhere (cuDNN convs default to it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("   TF32 off for matmul and cuDNN in the f32 comparisons")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    say("== 3. kernel 1: AlignConv forward vs plain")
    worst = {}
    cases = [  # name, (b, h, w, c, cout), offset scale, dtype, tolerance
        ("P3 bf16", (8, 128, 128, 256, 256), 1.5, torch.bfloat16, 2e-2),
        ("P3 f32", (8, 128, 128, 256, 256), 1.5, torch.float32, 1e-4),
        ("1x1", (2, 1, 1, 256, 256), 3.0, torch.float32, 1e-4),
        ("2x2", (2, 2, 2, 256, 256), 3.0, torch.float32, 1e-4),
        ("odd 19x41 C40->24", (1, 19, 41, 40, 24), 6.0, torch.float32, 1e-4),
        ("odd 3x37 bf16", (3, 3, 37, 256, 256), 6.0, torch.bfloat16, 2e-2),
        ("odd 19x41 C40->24 bf16", (1, 19, 41, 40, 24), 6.0, torch.bfloat16, 2e-2),
        ("P7 bf16", (8, 8, 8, 256, 256), 1.5, torch.bfloat16, 2e-2),
        ("1x1 bf16", (2, 1, 1, 256, 256), 3.0, torch.bfloat16, 2e-2),
        ("odd 19x41 C264->264 bf16", (1, 19, 41, 264, 264), 3.0, torch.bfloat16, 2e-2),
    ]
    for name, (b, h, w, c, co), scale, dtype, tol in cases:
        x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
        off = torch.randn(b, h, w, 9, 2, generator=gen, device=dev) * scale
        off[:, : max(1, h // 4), :, :3, 0] -= 500.0  # far outside: exact zeros
        wt = (torch.randn(3, 3, c, co, generator=gen, device=dev) * 0.05).to(dtype)
        got = dc.deform_conv2d_cuda(x, off.to(dtype), wt)
        torch.cuda.synchronize()
        ref = dc.deform_conv2d_plain(x, off.to(dtype), wt)
        err = (got.float() - ref.float()).abs().max().item()
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        check(got.dtype == dtype and torch.allclose(got.float(), ref.float(),
                                                    rtol=tol, atol=tol),
              f"{name}: max |kernel - plain| = {err:.3g} (rtol = atol = {tol})")
    deform_err = worst[torch.bfloat16]
    # centre tap, identity W: the output is the samples themselves, which
    # kernel and plain version form with the same roundings
    eye = torch.zeros(3, 3, 256, 256, device=dev)
    eye[1, 1] = torch.eye(256, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(8, 64, 64, 256, generator=gen, device=dev).to(dtype)
        off = (torch.randn(8, 64, 64, 9, 2, generator=gen, device=dev) * 1.5).to(dtype)
        got = dc.deform_conv2d_cuda(x, off, eye.to(dtype))
        torch.cuda.synchronize()
        check(torch.equal(got, dc.deform_conv2d_plain(x, off, eye.to(dtype))),
              f"samples {str(dtype)[6:]} (centre tap, identity W): kernel == plain bit for bit")

    say("== 4. kernel 2: rotated IoU and NMS vs plain")
    b1 = torch.cat([torch.rand(2000, 2, generator=gen, device=dev) * 1024,
                    torch.rand(2000, 2, generator=gen, device=dev) * 76 + 4,
                    torch.rand(2000, 1, generator=gen, device=dev) * 3.1 - 0.8], 1)
    b2 = b1[torch.randperm(2000, generator=gen, device=dev)[:1500]] + torch.randn(
        1500, 5, generator=gen, device=dev) * torch.tensor([8.0, 8.0, 2.0, 2.0, 0.1], device=dev)
    b2[:, 2:4] = b2[:, 2:4].abs() + 1
    got = iou.box_iou_rotated_cuda(b1, b2)
    torch.cuda.synchronize()
    ref = iou.box_iou_rotated_plain(b1, b2)
    err = (got - ref).abs().max().item()
    check(err <= 1e-6 and (got > 0).sum().item() > 1000,
          f"random 2000x1500: max |kernel - plain| = {err:.3g} (atol 1e-6), "
          f"{(got > 0).sum().item()} overlapping pairs")
    deg = degenerate_boxes(torch, dev)
    got = iou.box_iou_rotated_cuda(deg, deg)
    torch.cuda.synchronize()
    ref = iou.box_iou_rotated_plain(deg, deg)
    derr = (got - ref).abs().max().item()
    real = deg.shape[0] - 3
    check(derr <= 1e-6 and (got.diagonal()[:real] - 1).abs().max().item() <= 1e-6
          and (got[:, real:] == 0).all().item(),
          f"degenerate geometries: max |kernel - plain| = {derr:.3g}, diag = 1")
    iou_err = max(err, derr)
    # batched, one launch: shared boxes1 (batch stride 0) and per-image
    # boxes1, 1000 rows (not a multiple of the 64-row tile), 130 columns
    # (three passes) with a padded zero slot; the degenerate set as a batch
    rows1 = b1[:1000]
    per_img = rows1[None] + torch.randn(3, 1000, 5, generator=gen, device=dev) * torch.tensor(
        [4.0, 4.0, 0.0, 0.0, 0.05], device=dev)
    cols2 = b2[None, :130].repeat(3, 1, 1) + torch.randn(3, 130, 5, generator=gen, device=dev)
    cols2[:, :, 2:4] = cols2[:, :, 2:4].abs() + 1
    cols2[:, -1] = 0.0
    for name, a, g in (("shared boxes1 [1000, 5] x [3, 130, 5]", rows1, cols2),
                       ("per-image boxes1 [3, 1000, 5] x [3, 130, 5]", per_img, cols2),
                       ("degenerate [25, 5] x [3, 25, 5]", deg, deg[None].repeat(3, 1, 1))):
        before = iou.BOX_IOU.launches
        got = iou.box_iou_rotated_cuda(a, g)
        torch.cuda.synchronize()
        berr = (got - iou.box_iou_rotated_plain(a, g)).abs().max().item()
        check(berr <= 1e-6 and iou.BOX_IOU.launches == before + 1
              and (got[:, :, -1] == 0).all().item(),
              f"batched IoU, one launch, {name}: max |kernel - plain| = {berr:.3g} (atol "
              f"1e-6), {(got > 0).sum().item()} overlapping pairs")
        iou_err = max(iou_err, berr)

    clustered = clustered_candidates(torch, gen, BATCH, 4096, dev)
    # the same boxes with valid flags that are not a prefix
    scattered = clustered[:2] + (clustered[2] & (torch.rand(
        clustered[2].shape, generator=gen, device=dev) < 0.7),)
    deg_cand = (deg[None], torch.zeros(1, deg.shape[0], dtype=torch.int64, device=dev),
                torch.ones(1, deg.shape[0], dtype=torch.bool, device=dev))
    none_valid = clustered[:2] + (torch.zeros_like(clustered[2]),)
    for name, (boxes, labels, valid) in (("8 x 4096 clustered", clustered),
                                         ("8 x 4096 clustered, valid not a prefix", scattered),
                                         ("8 x 4096 clustered, none valid", none_valid),
                                         (f"{deg.shape[0]} degenerate boxes", deg_cand)):
        diff, pairs = mask_bits_differing(torch, nms, boxes, labels, valid, 0.5)
        keep_k = nms.nms_keep_cuda(boxes, labels, valid, 0.5)
        torch.cuda.synchronize()
        keep_p = nms.nms_keep_plain(boxes, labels, valid, 0.5)
        check(diff == 0 and torch.equal(keep_k, keep_p),
              f"NMS on {name} candidates: mask bits of valid rows differing {diff} "
              f"({pairs} suppressing pairs); keeps identical ({keep_k.sum().item()} kept of "
              f"{valid.sum().item()} valid)")
    boxes, labels, valid = clustered
    # ties: sigmoids of bf16 logits, as the serving scores; the card's top-k
    # order is the CPU's, which is lax.top_k's (tests/test_torch_port_topk.py)
    tied = torch.sigmoid(torch.randn(BATCH, 80160, generator=gen, device=dev).bfloat16().float())
    tied = torch.where(tied > 0.3, tied, -1.0)
    tv, ti = topk.top_k(tied, 4096)
    cv_, ci = topk.top_k(tied.cpu(), 4096)
    moved = (tied.topk(4096, dim=1)[1] != ti).sum().item()
    check(torch.equal(ti.cpu(), ci) and torch.equal(tv.cpu(), cv_),
          f"top_k on {BATCH} x 80160 bf16-tied scores: the card's order equals the CPU's "
          f"({len(torch.unique(tv[0]))} distinct values in image 0's top 4096; torch.topk "
          f"puts {moved} of {ti.numel()} indices elsewhere)")

    say("== 5. serving path")
    cfg = ModelConfig()
    torch.backends.cudnn.benchmark = True
    kernels = [dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    summary = port_predict.main([
        "--synthetic", str(BATCH), "--batch-size", str(BATCH),
        "--img-size", str(SIZE), "--seed", str(SEED), "--conf", str(cfg.score_thr),
        "--save-dir", str(out_dir / "predict")])
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    say(f"   predict: {summary['chips']} chips, {summary['detections']} detections "
        f"at score_thr {cfg.score_thr} in {time.perf_counter() - t0:.1f} s "
        f"(model build and first-batch autotuning included)")
    check(all(n > 0 for n in launches.values()), f"launch counts {launches}")

    pred = port_predict.S2ANetPredictor(cfg, device="cuda", dtype=torch.bfloat16,
                                        seed=SEED)
    imgs = np.random.default_rng(SEED).integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                                dtype=np.uint8)
    x = pred.to_input(imgs)
    out = pred.forward(x)
    finite = all(torch.isfinite(t).all().item() for v in out.values() for t in v)
    shapes_ok = all(out["odm_cls"][i].shape == (BATCH, SIZE // s, SIZE // s, 15)
                    for i, s in enumerate(cfg.strides))
    det = head_mod.s2anet_get_bboxes(out, **pred.post_kwargs())
    check(finite and shapes_ok and det[0].shape == (BATCH, cfg.max_per_img, 6)
          and torch.isfinite(det[0]).all().item(),
          "head outputs finite, shapes [8, 1024/s, 1024/s, 15]; det_boxes [8, 2000, 6] finite")

    # kernel path against plain path at score_thr 0.005. Random-weight ODM
    # scores are near-ties (all about sigmoid(bias) = 0.0101). The two
    # AlignConv versions form the same samples but sum the products in
    # another order; in bf16 that flips the last bit of about 0.1% of the
    # outputs, the flips spread through the bf16 ODM stacks, and the NMS then
    # keeps a neighbouring anchor of the same object here and there. So bf16
    # holds the 95% bar on (label, score, rotated IoU >= 0.5) matches and
    # reports the centre-within-1-px matches; float32 (TF32 off) holds it
    # on the centre-within-1-px matches.
    def both_paths(p, xin):
        out_k = p.forward(xin)
        bk, sk = decode_levels(out_k, cfg.max_before_nms_per_level)
        det_k = [t.cpu().numpy() for t in nms.multiclass_nms_rotated(
            bk, sk, 0.005, cfg.nms_iou_thr, cfg.max_per_img, cfg.pre_nms_cap)]
        with mock.patch.object(head_mod, "deform_conv2d", dc.deform_conv2d_plain), \
                mock.patch.object(nms, "nms_keep", nms.nms_keep_plain):
            out_p = p.forward(xin)
            bp, sp = decode_levels(out_p, cfg.max_before_nms_per_level)
            det_p = [t.cpu().numpy() for t in nms.multiclass_nms_rotated(
                bp, sp, 0.005, cfg.nms_iou_thr, cfg.max_per_img, cfg.pre_nms_cap)]
        logit_err = max((a - b).abs().max().item()
                        for key in ("odm_cls", "odm_bbox")
                        for a, b in zip(out_k[key], out_p[key]))
        centre, by_iou, total = detection_agreement(torch, dev, det_k, det_p)
        return bk, sk, int(det_k[2].sum()), centre, by_iou, total, logit_err

    boxes_k, scores_k, n_det, centre, by_iou, total, lerr = both_paths(pred, x)
    check(by_iou >= 0.95 and n_det > 0,
          f"bfloat16, score_thr 0.005: {n_det} detections; kernel vs plain path "
          f"matched 1:1 by IoU {by_iou:.4f}, by centre {centre:.4f} (of {total}); "
          f"ODM outputs max |kernel - plain| {lerr:.3g}")
    torch.backends.cudnn.benchmark = False
    pred32 = port_predict.S2ANetPredictor(cfg, device="cuda", dtype=torch.float32,
                                          seed=SEED)
    _, _, n32, centre32, by_iou32, t32, lerr32 = both_paths(pred32,
                                                            pred32.to_input(imgs))
    check(centre32 >= 0.95 and n32 > 0,
          f"float32, score_thr 0.005: {n32} detections; kernel vs plain path "
          f"matched 1:1 by centre {centre32:.4f}, by IoU {by_iou32:.4f} (of {t32}); "
          f"ODM outputs max |kernel - plain| {lerr32:.3g}")
    del pred32
    torch.backends.cudnn.benchmark = True

    # NMS kernels on the main path's own candidates
    _, cb, cl, cv = nms.select_candidates(boxes_k, scores_k, 0.005, cfg.pre_nms_cap)
    k = cb.shape[1]
    n = int(cv.sum(1).max())
    cbc, clc, cvc = cb.contiguous(), cl.int().contiguous(), cv.contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    mask = torch.empty(BATCH, k, (k + 63) // 64, dtype=torch.int64, device=dev)
    mask_diff, n_pairs = mask_bits_differing(torch, nms, cb, cl, cv, cfg.nms_iou_thr)
    over = nms.overlap_plain(cb, cl, cv, cfg.nms_iou_thr, n)
    keep_k = nms.nms_keep_cuda(cb, cl, cv, cfg.nms_iou_thr)
    keep_p = nms.nms_keep_plain(cb, cl, cv, cfg.nms_iou_thr)
    keep_diff = (keep_k != keep_p).sum().item()
    check(mask_diff == 0 and keep_diff == 0,
          f"main-path candidates ({n} valid of {k}): mask bits of valid rows differing "
          f"{mask_diff}, keeps differing {keep_diff} ({n_pairs} suppressing pairs)")

    say("== 6. times")
    say(f"   card: {card}")
    # serve as users would: PyTorch's defaults (TF32 in cuDNN convs, which
    # only the float32 prediction heads use; not in matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    say("   timing with PyTorch's TF32 defaults (cuDNN on, matmul off)")
    for _ in range(2):
        pred.predict(imgs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_timed = 7
    lat = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        res = pred.predict(imgs)
        res[0].sum().item()
        lat.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chips_s = n_timed * BATCH / sum(lat)
    say(f"   main path: {chips_s:.2f} chips/s at batch {BATCH}, {SIZE}x{SIZE} bf16; "
        f"batch ms {[round(1000 * t, 1) for t in lat]}; peak memory {peak:.2f} GiB")
    # the traffic where the NMS has work: at score_thr 0.005 the random-weight
    # scores give every image pre_nms_cap valid candidates
    pred.predict(imgs, score_thr=0.005)[0].sum().item()
    lat_busy = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        pred.predict(imgs, score_thr=0.005)[0].sum().item()
        lat_busy.append(time.perf_counter() - t0)
    say(f"   at score_thr 0.005 ({n} valid NMS candidates per image): "
        f"{n_timed * BATCH / sum(lat_busy):.2f} chips/s; batch ms "
        f"{[round(1000 * t, 1) for t in lat_busy]} (score_thr {cfg.score_thr}: {chips_s:.2f})")

    # AlignConv at the five levels' shapes of one batch
    levels = []
    for s in cfg.strides:
        hw = SIZE // s
        xl = torch.randn(BATCH, hw, hw, 256, generator=gen, device=dev).bfloat16()
        ol = (torch.randn(BATCH, hw, hw, 9, 2, generator=gen, device=dev) * 1.5).bfloat16()
        wl = (torch.randn(3, 3, 256, 256, generator=gen, device=dev) * 0.05).bfloat16()
        levels.append((xl, ol, wl))
    t_dk, s_dk = cuda_ms(torch, lambda: [dc.deform_conv2d_cuda(*a) for a in levels], 10)
    t_dp, _ = cuda_ms(torch, lambda: [dc.deform_conv2d_plain(*a) for a in levels], 1)
    nbytes = ops = 0
    for xl, _, wl in levels:
        cells, c, co = xl.numel() // xl.shape[-1], xl.shape[-1], wl.shape[-1]
        nbytes += cells * (2 * c + 18 * 4 + 2 * co) + 9 * c * co * 2
        ops += 2 * cells * 9 * c * co
    fwd_bound = bound(nbytes, ops, BF16_FLOP_S)
    say(f"   deform_conv2d P3-P7 (one batch, bf16): kernel {t_dk:.3f} ms (median of "
        f"{REPEATS}, spread {s_dk:.1%}), plain {t_dp:.3f} ms, bound {fwd_bound[0]:.3f} ms "
        f"({fwd_bound[1]}: {ops / 1e9:.0f} GFLOP)")
    # per level, beside the yardstick of cuDNN's bf16 channels-last 3x3
    # convolution of the same shape: the same multiply-adds without the gather
    dense_ms = 0.0
    for name, (xl, ol, wl) in zip(LEVELS, levels):
        cells, c, co = xl.numel() // xl.shape[-1], xl.shape[-1], wl.shape[-1]
        t_l, _ = cuda_ms(torch, lambda xl=xl, ol=ol, wl=wl: dc.deform_conv2d_cuda(xl, ol, wl), 10)
        xc = xl.permute(0, 3, 1, 2)  # NHWC memory is channels-last NCHW
        wc = wl.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        t_c, _ = cuda_ms(torch, lambda xc=xc, wc=wc: F.conv2d(xc, wc, padding=1), 10)
        dense_ms += t_c
        flop = 2 * cells * 9 * c * co
        say(f"   {name} {tuple(xl.shape)}: kernel {t_l:.4f} ms ({rate(flop, t_l):.1f} TFLOP/s, "
            f"gathered {rate(gather_bytes(cells, c), t_l):.2f} TB/s); dense_conv_ms "
            f"{t_c:.4f} (cuDNN 3x3, {rate(flop, t_c):.1f} TFLOP/s)")
    say(f"   P3-P7: dense_conv_ms {dense_ms:.3f} (the yardstick; library_ms stays null: no "
        f"PyTorch call computes a deformable convolution)")

    def run_mask():
        nms.NMS_MASK(cbc.data_ptr(), clc.data_ptr(), cvc.data_ptr(), cfg.nms_iou_thr,
                     mask.data_ptr(), BATCH, k, stream)

    keep_buf = torch.empty(BATCH, k, dtype=torch.bool, device=dev)

    no_valid = torch.zeros_like(cvc)

    def run_sweep(ok=cvc):
        nms.NMS_SWEEP(mask.data_ptr(), ok.data_ptr(), keep_buf.data_ptr(), BATCH, k, stream)

    t_mk, s_mk = cuda_ms(torch, run_mask, 10)
    t_s0, s_s0 = cuda_ms(torch, lambda: run_sweep(no_valid), 10)
    t_sk, s_sk = cuda_ms(torch, run_sweep, 10)
    t_mp, _ = cuda_ms(torch, lambda: nms.overlap_plain(cb, cl, cv, cfg.nms_iou_thr, n), 1)
    t_sp, _ = cuda_ms(torch, lambda: nms.sweep_plain(over, cv[:, :n]), 1)
    m_bound = mask_bound(torch, cb, cl, cv)
    # sweep: the diagonal words, and each survivor's words right of its block
    cols = (k + 63) // 64
    kept = keep_buf.nonzero()[:, 1]
    sweep_words = BATCH * k + (cols - kept // 64 - 1).sum().item()
    sweep_bound = bound(8 * sweep_words + 2 * BATCH * k, 0, F32_FLOP_S)
    say(f"   NMS on the main path's candidates (8 x {k}, {n} valid max): mask kernel "
        f"{t_mk:.3f} ms (spread {s_mk:.1%}) vs plain overlap {t_mp:.3f} ms, bound "
        f"{m_bound[0]:.4f} ms ({m_bound[1]}): {m_bound[0] / t_mk:.1%} of the bound; sweep "
        f"kernel {t_sk:.3f} ms (spread {s_sk:.1%}) vs plain sweep {t_sp:.3f} ms, bound "
        f"{sweep_bound[0]:.4f} ms ({sweep_bound[1]})")
    rounds, worst, blocks = sweep_rounds(over, cv[:, :n])
    say(f"   NMS sweep with no valid candidate: {t_s0:.4f} ms (spread {s_s0:.1%}); the round "
        f"rule replayed in numpy on this mask (a model, not a count read from the kernel): "
        f"{rounds} rounds over {blocks} blocks of 64 candidates, at most {worst} in a block, "
        f"against 64 dependent steps a block")
    # part A's cost: decode + select of a serving batch at score_thr 0.005
    # with each top-k in turns (torch.topk: the order before the tie fix)
    out_ds = pred.forward(x)
    variants = {"torch.topk (before)": lambda t, kk: t.topk(kk, dim=-1),
                "stable sort (top_k, the port's)": topk.top_k}

    def decode_select(fn):
        with mock.patch.object(head_mod, "top_k", fn), mock.patch.object(nms, "top_k", fn):
            bx, sc = decode_levels(out_ds, cfg.max_before_nms_per_level)
            top_s, _, _, _ = nms.select_candidates(bx, sc, 0.005, cfg.pre_nms_cap)
            return nms.top_k(top_s, cfg.max_per_img)

    ds_times = {name: [] for name in variants}
    for fn in variants.values():
        decode_select(fn)
    for _ in range(REPEATS):
        for name, fn in variants.items():
            ds_times[name].append(loop_ms(torch, lambda fn=fn: decode_select(fn), 10))
    ds_ms = {name: median_spread(ts) for name, ts in ds_times.items()}
    ds_launches = {name: device_launches(torch, lambda fn=fn: decode_select(fn))
                   for name, fn in variants.items()}
    say("   decode + select of a serving batch at score_thr 0.005 (sigmoid, per-level "
        "top-2000, decode, top-4096 candidates, top-2000 survivors), in turns: "
        + "; ".join(f"{name} {ms:.3f} ms (spread {sp:.1%}), {ds_launches[name]} launches"
                    for name, (ms, sp) in ds_ms.items()))
    # and in the serving batch, end to end: both orders in turns, in this
    # process, at both score thresholds
    e2e = {(name, thr): [] for name in variants for thr in (cfg.score_thr, 0.005)}
    for _ in range(REPEATS):
        for (name, thr), ts in e2e.items():
            with mock.patch.object(head_mod, "top_k", variants[name]), \
                    mock.patch.object(nms, "top_k", variants[name]):
                t0 = time.perf_counter()
                for _ in range(3):
                    pred.predict(imgs, score_thr=thr)[0].sum().item()
                ts.append((time.perf_counter() - t0) / 3 * 1000)
    say("   serving batch wall with each top-k order, in turns (median of "
        f"{REPEATS} x 3 batches): "
        + "; ".join(f"{name} at score_thr {thr} {median_spread(ts)[0]:.2f} ms (spread "
                    f"{median_spread(ts)[1]:.1%})" for (name, thr), ts in e2e.items()))
    # a crowded scene: the circle test rejects fewer pairs
    clu = nms._mask_inputs(*clustered)
    t_mc, s_mc = cuda_ms(torch, lambda: nms._mask(*clu, cfg.nms_iou_thr, stream), 10)
    c_bound = mask_bound(torch, *clustered)
    say(f"   NMS mask on 8 x 4096 clustered candidates ({int(clustered[2].sum())} valid): "
        f"kernel {t_mc:.3f} ms (spread {s_mc:.1%}), bound {c_bound[0]:.4f} ms ({c_bound[1]}): "
        f"{c_bound[0] / t_mc:.1%} of the bound")
    c0 = cb[0].contiguous()
    t_ik4, _ = cuda_ms(torch, lambda: iou.box_iou_rotated_cuda(c0, c0), 10)
    say(f"   box_iou_rotated {k}x{k} (image 0's candidates): kernel {t_ik4:.3f} ms "
        f"(max |kernel - plain| {iou_err:.3g})")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred.predict(imgs)[0].sum().item()
    avg = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    (out_dir / "chip_smoke_profile.txt").write_text(
        f"{card}\n{avg.table(sort_by=key, row_limit=60)}\n")
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                   and getattr(e, key) > 0), key=lambda e: -getattr(e, key))
    busy = sum(getattr(e, key) for e in kern) / 1000
    groups: dict = {}
    for e in kern:
        name = e.key
        g = ("AlignConv kernel" if "deform_fwd" in name else
             "NMS kernels" if "nms_" in name else
             "convolutions (cuDNN)" if any(t in name for t in ("conv", "xmma", "gemm", "cutlass", "sm90"))
             else "memcpy" if "Memcpy" in name or "Memset" in name else
             "elementwise, reductions, sort, gather")
        groups[g] = groups.get(g, 0.0) + getattr(e, key) / 1000
    wall = 1000 * sum(lat) / len(lat)
    say(f"   profile of one batch: {busy:.2f} ms of kernels in {sum(e.count for e in kern)} "
        f"launches; timed batch wall {wall:.2f} ms -> device idle share "
        f"{max(0.0, 1 - busy / wall):.3f}")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        say(f"     {t:9.3f} ms  {100 * t / busy:5.1f}%  {g}")
    say("   top kernels:")
    for e in kern[:12]:
        say(f"     {getattr(e, key) / 1000:9.3f} ms  {e.count:5d}x  {e.key[:100]}")

    del pred, res, out, det
    torch.cuda.empty_cache()

    deform_bwd = phase_deform_bwd(torch, dev, gen, levels)
    del levels
    bn_rows = phase_moments(torch, dev, gen)
    train_launches, train_summary, gt_all = phase_train(torch, dev, card, out_dir)

    # the IoU kernel at the assignment's shape, one call for the batch as
    # assign_labels makes it: the R-50 1024^2 anchors (shared, as the FAM
    # stage passes them; and jittered per image, as the ODM stage's refined
    # anchors) against the 64 gt slots of each of the 8 images
    anchors = torch.from_numpy(np.concatenate([
        grid_anchors((SIZE // st, SIZE // st), st) for st in cfg.strides])).to(dev)
    gts = torch.from_numpy(gt_all).to(dev)
    refined = anchors[None] + torch.randn(BATCH, anchors.shape[0], 5, generator=gen,
                                          device=dev) * torch.tensor(
        [2.0, 2.0, 1.0, 1.0, 0.05], device=dev)
    a, g = anchors.shape[0], gts.shape[1]
    iou_calls = {}
    for name, anc in (("shared anchors (FAM stage)", anchors),
                      ("per-image anchors (ODM stage)", refined)):
        got = iou.box_iou_rotated_cuda(anc, gts)
        torch.cuda.synchronize()
        a_err = (got - iou.box_iou_rotated_plain(anc, gts)).abs().max().item()
        t_ik, s_ik = cuda_ms(torch, lambda anc=anc: iou.box_iou_rotated_cuda(anc, gts), 20)
        t_ip, _ = cuda_ms(torch, lambda anc=anc: iou.box_iou_rotated_plain(anc, gts), 1)
        rows1 = 1 if anc.dim() == 2 else BATCH
        ops = sum(iou_ops(torch, anc if anc.dim() == 2 else anc[i], gts[i])
                  for i in range(BATCH))
        i_bound = bound(4 * (5 * a * rows1 + 5 * BATCH * g + BATCH * a * g), ops, F32_FLOP_S)
        check(a_err <= 1e-6, f"box_iou_rotated at the assignment shape, {name}, "
              f"[{rows1}, {a}, 5] x [{BATCH}, {g}, 5], one launch: kernel {t_ik:.4f} ms "
              f"(spread {s_ik:.1%}), plain {t_ip:.3f} ms, bound {i_bound[0]:.4f} ms "
              f"({i_bound[1]}): {i_bound[0] / t_ik:.1%} of the bound; max |kernel - plain| "
              f"{a_err:.3g}")
        iou_err = max(iou_err, a_err)
        iou_calls[name] = (t_ik, t_ip, i_bound)
    (t_ik, t_ip, iou_bound), (t_ik2, _, iou_bound2) = iou_calls.values()
    say(f"   the two calls of a step: {t_ik + t_ik2:.4f} ms")

    phase_step_vs_plain(torch, dev)
    eval_launches, eval_root, bf16_listed_rate = phase_eval(torch, dev, out_dir, keep=True)
    try:
        phase_train_loop(torch, out_dir, train_summary["ms_per_step"])
        quant_rows = phase_quant(torch, dev, out_dir, eval_root, bf16_listed_rate, parent)
        scene = np.load(eval_root / "scene" / "scene_0000.npy")  # for phase 17
    finally:
        shutil.rmtree(eval_root, ignore_errors=True)  # phase 11's 100 MB of images
    try:
        rect = phase_rect(torch, dev, out_dir)
    finally:
        shutil.rmtree(out_dir / "hrsc", ignore_errors=True)
    for r in quant_rows:  # the int8 rows: launches of the val --rect --quant int8 run
        r["rect_launches"] = rect["s2a_int8_conv2d" if "conv" in r["name"] else "s2a_quantize_act"]
    try:
        option_launches, option_ms, sampled_err, prefix_ms = phase_options(torch, dev, out_dir)
    finally:
        shutil.rmtree(out_dir / "options", ignore_errors=True)
    try:
        fused, dp_launches = phase_data_parallel(torch, dev, out_dir, parent)
    finally:
        for d in ("dp", "dp_cli"):
            shutil.rmtree(out_dir / d, ignore_errors=True)
    try:
        spatial_launches, spatial_times = phase_spatial(torch, dev, out_dir, scene)
    finally:
        shutil.rmtree(out_dir / "spatial", ignore_errors=True)
    try:
        image_launches = phase_images(torch, dev, out_dir, keep_files=True)
        export_launches = phase_export(torch, dev, out_dir, chips_s, parent)
    finally:
        shutil.rmtree(out_dir / "images", ignore_errors=True)
        shutil.rmtree(out_dir / "export", ignore_errors=True)
    pan = phase_pan(torch, dev)

    say(card)
    src_d = "s2anet_tpu_torch/csrc/deform_conv.cu"
    src_i = "s2anet_tpu_torch/csrc/iou_nms_rotated.cu"
    src_m = "s2anet_tpu_torch/csrc/bn_moments.cu"
    rows = [
        dict(name="deform_conv2d_fwd", source=src_d,
             replaces="s2anet_tpu/ops/pallas/deform_kernel.py:195",
             launches=train_launches["s2a_deform_conv2d_fwd"], path="train",
             eval_launches=eval_launches["s2a_deform_conv2d_fwd"],
             rect_launches=rect["s2a_deform_conv2d_fwd"],
             spatial_launches=spatial_launches["s2a_deform_conv2d_fwd"],
             image_launches=image_launches["s2a_deform_conv2d_fwd"],
             export_launches=export_launches["s2a_deform_conv2d_fwd"],
             max_abs_err=deform_err, ms=t_dk, plain_ms=t_dp, bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None, dense_conv_ms=dense_ms, **spatial_times),
        dict(name="deform_conv2d_bwd", source=src_d,
             replaces="s2anet_tpu/ops/pallas/deform_kernel.py:263",
             launches=train_launches["s2a_deform_conv2d_bwd"], path="train", **deform_bwd),
        dict(name="box_iou_rotated", source=src_i,
             replaces="s2anet_tpu/ops/pallas/iou_kernel.py:46",
             launches=train_launches["s2a_box_iou_rotated"], path="train",
             max_abs_err=iou_err, ms=t_ik, plain_ms=t_ip, bound_ms=iou_bound[0],
             bound_by=iou_bound[1], library_ms=None, per_image_ms=t_ik2,
             per_image_bound_ms=iou_bound2[0]),
        dict(name="nms_rotated_mask", source=src_i,
             replaces="s2anet_tpu/ops/pallas/iou_kernel.py:46",
             launches=launches["s2a_nms_rotated_mask"], path="serve",
             eval_launches=eval_launches["s2a_nms_rotated_mask"],
             rect_launches=rect["s2a_nms_rotated_mask"],
             spatial_launches=spatial_launches["s2a_nms_rotated_mask"],
             image_launches=image_launches["s2a_nms_rotated_mask"],
             export_launches=export_launches["s2a_nms_rotated_mask"],
             max_abs_err=float(mask_diff > 0), ms=t_mk, plain_ms=t_mp,
             bound_ms=m_bound[0], bound_by=m_bound[1], library_ms=None,
             clustered_ms=t_mc, clustered_bound_ms=c_bound[0]),
        dict(name="nms_rotated_sweep", source=src_i,
             replaces="s2anet_tpu/ops/nms_rotated.py:28",
             launches=launches["s2a_nms_rotated_sweep"], path="serve",
             eval_launches=eval_launches["s2a_nms_rotated_sweep"],
             rect_launches=rect["s2a_nms_rotated_sweep"],
             spatial_launches=spatial_launches["s2a_nms_rotated_sweep"],
             image_launches=image_launches["s2a_nms_rotated_sweep"],
             export_launches=export_launches["s2a_nms_rotated_sweep"],
             max_abs_err=float(keep_diff > 0), ms=t_sk, plain_ms=t_sp,
             bound_ms=sweep_bound[0], bound_by=sweep_bound[1], library_ms=None,
             no_valid_ms=t_s0),
        dict(name="channel_moments", source=src_m,
             replaces="s2anet_tpu/ops/pallas/moments.py:43",
             launches=train_launches["s2a_channel_moments"], path="train", **bn_rows["moments"],
             sampled_max_abs_err=sampled_err["moments"],
             prefix2_device_ms=prefix_ms["prefix 2"], full_device_ms=prefix_ms["full batch"]),
        dict(name="grad_channel_sums", source=src_m,
             replaces="s2anet_tpu/ops/pallas/moments.py:60",
             launches=train_launches["s2a_grad_channel_sums"], path="train", **bn_rows["pair"],
             sampled_max_abs_err=sampled_err["pair"]),
        dict(name="bn_apply", source=src_m, replaces="s2anet_tpu/models/bn.py:108",
             launches=train_launches["s2a_bn_apply"], path="train", **bn_rows["apply"]),
        dict(name="bn_dx", source=src_m, replaces="s2anet_tpu/models/bn.py:140",
             launches=train_launches["s2a_bn_dx"], path="train", **bn_rows["dx"],
             sampled_max_abs_err=sampled_err["dx"]),
        dict(name="bn_apply_finish", source=src_m, replaces="s2anet_tpu/models/bn.py:105",
             launches=dp_launches["s2a_bn_apply_finish"], path="data-parallel train",
             **fused["apply"]),
        dict(name="bn_dx_finish", source=src_m, replaces="s2anet_tpu/models/bn.py:135",
             launches=dp_launches["s2a_bn_dx_finish"], path="data-parallel train",
             **fused["dx"]),
    ] + quant_rows
    for r in rows:  # launches a train step of each configuration of phase 15
        sym = "s2a_" + r["name"]
        if sym in pan:  # and a serving batch behind the PAN neck (phase 20b)
            r["pan_launches"] = pan[sym]
        if f"int8 {sym}" in pan:  # the int8 PAN's (phase 20c), with its time a batch
            r["pan_launches"] = pan[f"int8 {sym}"]
            part = pan["conv" if "conv" in sym else "quantize"]
            r["pan_ms"], r["pan_bound_ms"] = part["ms"], part["bound_ms"]
        if sym in option_launches["default"]:
            r["option_launches"] = {name: per[sym] for name, per in option_launches.items()}
        if sym in dp_launches:  # and a data-parallel step's, on rank 0 (phase 16a)
            r["dp_launches"] = dp_launches[sym]
    say("   phase 15 ms/step: " + ", ".join(f"{name} {t:.2f}" for name, t in option_ms.items())
        + f"; {card}")
    say(json.dumps({"kernels": [{"name": r.pop("name"), "route": "cuda", **r}
                                for r in rows]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
