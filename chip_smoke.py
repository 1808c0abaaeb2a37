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
               labels the bf16 kernel path within 0.02 of the bf16 plain
               path (bf16 scores reorder random-weight near-ties)
 12. training run  32 train and 16 val synthetic 1024^2 DOTA-format chips
               (s2anet_tpu_torch.data.synth, 15 classes), then
               python -m s2anet_tpu_torch.train --config (configs/dota_r50.yaml
               with save_period 1) --data-root --val-root --epochs 2
               --batch-size 8: two results.csv rows with finite train and val
               losses and a val mAP50; weights/last, best, deploy; launches
               per train step as phase 9's (AlignConv 5/5, BN moments, pair,
               apply and dx 53 each, IoU 2) and per validation batch
               (AlignConv forward 5, IoU 2, NMS mask and sweep 1); a
               --resume from weights/epoch0 runs epoch 1 only, with 8 updates,
               the same LR and train losses within 5%; python -m
               s2anet_tpu_torch.val --weights weights/deploy on the val chips
               (folded BN) within 0.02 mAP50 of the trainer's last
               validation. Prints the loop's ms/step (both epochs, and each
               epoch to the device's end) beside phase 9's, the host's wait
               for the loader per step, the loader's augmented images/s
               alone (3 epochs), validation seconds and peak memory; then one
               16-step epoch (128 chips, no validation) with 4 and with 1
               loader threads: ms/step, the host's wait for the loader and
               its median time to enqueue a step; deletes the data

The line before the last is ``{"kernels": [...]}``: per kernel its launches
on its path (training, or serving for the NMS kernels; ``eval_launches``:
the val run of phase 11 for the kernels on that path), its largest error
against the plain version, its time, the plain version's and the library
call's time where there is one, and the least time the card could take
(``bound_ms``: the larger of the bytes over 3.35 TB/s and the operations
over 989 TFLOP/s bf16 or 67 TFLOP/s f32, H100 SXM). Every time is the
median of 5 timed loops (CUDA events); lines give the spread. The last
line is ``{"ok": true, "device": {...}}``. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
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
# H100 SXM peaks (NVIDIA's data sheet; full rates at 700 W)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
# float32 operations of one iou_pair (csrc/iou_nms_rotated.cu), counted
# with a division or a transcendental as one: a pair past the bounding-
# circle test (two clip passes of 4 edges x 4 half-planes, ~30 each, plus
# the corners) and a pair the test rejects
IOU_PAIR_OPS, IOU_REJECT_OPS = 1100, 15


def say(msg: str) -> None:
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


def device_launches(torch, fn) -> int:
    """Kernels, copies and fills that one call of ``fn`` puts on the device
    (profiler; one warm-up call first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


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
          and per["s2a_box_iou_rotated"] == 2 and per["s2a_nms_rotated_mask"] == 0,
          f"launches per step {per}")

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
               else "BN sums and finishing kernels (moments, pair)" if "partial_sums" in name
               or "finish_sums" in name or "channel_sums" in name
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


def phase_eval(torch, dev, out_dir):
    """The evaluation path (section 11 of the module docstring); returns the
    val run's launches of the kernels on its path."""
    import dataclasses
    import shutil

    from s2anet_tpu_torch import native
    from s2anet_tpu_torch import predict as port_predict
    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.config import DOTA10_CLASSES, Config, DataConfig, EvalConfig, ModelConfig
    from s2anet_tpu_torch.data.dota import BatchLoader, DotaDataset
    from s2anet_tpu_torch.data.split import window_origins
    from s2anet_tpu_torch.eval.runner import evaluate_on_chips, score_detections
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

    args = ["--source", str(root / "scene"), "--batch-size", str(BATCH), "--conf", "0.005",
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
        gt_dir = root / ("labels_" + src.replace(" ", "_"))
        n_gt, lo, hi = relabel(gt_dir, dets[src], DOTA10_CLASSES, GT_PER_CLASS)
        scfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, val_gt_dir=str(gt_dir)),
            eval=dataclasses.replace(cfg.eval, is_map_split=False))
        for path in dets:
            r = score_detections(dets[path], scfg)
            labelled = [c["ap"] for c in r["per_class"].values() if c["npos"]]
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
    gap16 = abs(scores["plain f32", "kernel bf16"] - scores["plain f32", "plain bf16"])
    check(gap16 <= 0.02,
          f"against the float32 plain path's labels, bf16 scores by its dtype, not its "
          f"kernels: kernel {scores['plain f32', 'kernel bf16']:.4f}, plain "
          f"{scores['plain f32', 'plain bf16']:.4f} (|difference| {gap16:.4f} <= 0.02)")
    shutil.rmtree(root)  # 100 MB of images: keep the --out directory small
    return first_launches


TRAIN_CHIPS, VAL_CHIPS = 32, 16  # phase 12: synthetic 1024^2 chips
STEADY_CHIPS = 128  # phase 12: the train chips of its 16-step epoch


def phase_train_loop(torch, out_dir, step_ms):
    """The epoch loop (section 12 of the module docstring); ``step_ms`` is
    phase 9's ms/step, printed beside the loop's."""
    import csv
    import dataclasses
    import shutil

    from s2anet_tpu_torch import val as port_val
    from s2anet_tpu_torch.config import load_config
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
                            "s2a_grad_channel_sums": 0, "s2a_bn_apply": 0, "s2a_bn_dx": 0},
          f"validation launches over {val_batches} batches {counts['val']}")
    epoch_ms = [1000 * float(r["time/epoch_s"]) / (steps // 2) for r in rows]
    say(f"   {wall:.1f} s in all; epoch loop {summary['ms_per_step']:.2f} ms/step over both "
        f"epochs, to the device's end (epoch 0 {epoch_ms[0]:.2f}, epoch 1 {epoch_ms[1]:.2f}); "
        f"phase 9's synthetic step {step_ms:.2f} ms/step in this run")
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
                            "--batch-size", str(BATCH), "--seed", str(SEED), "--save-dir",
                            str(root / f"steady{workers}")], callbacks=steady)
        enqueue = np.subtract(marks["on_train_batch_end"], marks["on_train_batch_start"])
        say(f"   one {s['steps']}-step epoch, {workers} loader thread(s), no validation: "
            f"{s['ms_per_step']:.2f} ms/step to the device's end (phase 9: {step_ms:.2f}); "
            f"the host waits {s['loader_wait_ms_per_step']:.2f} ms a step for the loader and "
            f"enqueues a step in {1000 * np.median(enqueue):.2f} ms (median)")

    # resume from epoch 0's checkpoint into a new run dir: epoch 1 only
    for k in kernels:
        k.launches = 0
    resumed = train_cli.main(args + ["--save-dir", str(root / "resumed"), "--resume",
                                     str(run / "weights" / "epoch0")])
    with open(Path(resumed["save_dir"]) / "results.csv", newline="") as f:
        rrows = list(csv.DictReader(f))
    rel = max(abs(float(rrows[0][k]) / float(rows[1][k]) - 1)
              for k in rows[1] if k.startswith("train/"))
    check(resumed["steps"] == 4 and resumed["updates"] == summary["updates"] == 8
          and len(rrows) == 1 and rrows[0]["epoch_or_step"] == "1"
          and rrows[0]["lr/0"] == rows[1]["lr/0"] and rel < 0.05,
          f"--resume weights/epoch0: {resumed['steps']} steps (epoch 1 only), "
          f"{resumed['updates']} updates, lr {rrows[0]['lr/0']} (straight run "
          f"{rows[1]['lr/0']}), train losses within {rel:.2%} of the straight run's "
          f"(the AlignConv dx sums with atomics: not bit-equal on the card)")

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU")
    parser.add_argument("--out", default=str(ROOT / "runs" / "chip_smoke"),
                        help="directory for the predictions and the profile table")
    out_dir = Path(parser.parse_args(argv).out)

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
    libs = ("deform_conv", "iou_nms_rotated", "bn_moments")
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
        centre = by_iou = total = 0
        for i in range(BATCH):
            a, la = det_k[0][i][det_k[2][i]], det_k[1][i][det_k[2][i]]
            bb, lb = det_p[0][i][det_p[2][i]], det_p[1][i][det_p[2][i]]
            ious = iou.box_iou_rotated_plain(torch.from_numpy(a[:, :5]).to(dev),
                                             torch.from_numpy(bb[:, :5]).to(dev))
            centre += match_1to1(a, la, bb, lb)
            by_iou += match_1to1(a, la, bb, lb, ious.cpu().numpy())
            total += max(len(a), len(bb))
        total = max(total, 1)
        return (bk, sk, int(det_k[2].sum()), centre / total, by_iou / total,
                total, logit_err)

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
    eval_launches = phase_eval(torch, dev, out_dir)
    phase_train_loop(torch, out_dir, train_summary["ms_per_step"])

    say(card)
    src_d = "s2anet_tpu_torch/csrc/deform_conv.cu"
    src_i = "s2anet_tpu_torch/csrc/iou_nms_rotated.cu"
    src_m = "s2anet_tpu_torch/csrc/bn_moments.cu"
    rows = [
        dict(name="deform_conv2d_fwd", source=src_d,
             replaces="s2anet_tpu/ops/pallas/deform_kernel.py:195",
             launches=train_launches["s2a_deform_conv2d_fwd"], path="train",
             eval_launches=eval_launches["s2a_deform_conv2d_fwd"],
             max_abs_err=deform_err, ms=t_dk, plain_ms=t_dp, bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None, dense_conv_ms=dense_ms),
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
             max_abs_err=float(mask_diff > 0), ms=t_mk, plain_ms=t_mp,
             bound_ms=m_bound[0], bound_by=m_bound[1], library_ms=None,
             clustered_ms=t_mc, clustered_bound_ms=c_bound[0]),
        dict(name="nms_rotated_sweep", source=src_i,
             replaces="s2anet_tpu/ops/nms_rotated.py:28",
             launches=launches["s2a_nms_rotated_sweep"], path="serve",
             eval_launches=eval_launches["s2a_nms_rotated_sweep"],
             max_abs_err=float(keep_diff > 0), ms=t_sk, plain_ms=t_sp,
             bound_ms=sweep_bound[0], bound_by=sweep_bound[1], library_ms=None,
             no_valid_ms=t_s0),
        dict(name="channel_moments", source=src_m,
             replaces="s2anet_tpu/ops/pallas/moments.py:43",
             launches=train_launches["s2a_channel_moments"], path="train", **bn_rows["moments"]),
        dict(name="grad_channel_sums", source=src_m,
             replaces="s2anet_tpu/ops/pallas/moments.py:60",
             launches=train_launches["s2a_grad_channel_sums"], path="train", **bn_rows["pair"]),
        dict(name="bn_apply", source=src_m, replaces="s2anet_tpu/models/bn.py:108",
             launches=train_launches["s2a_bn_apply"], path="train", **bn_rows["apply"]),
        dict(name="bn_dx", source=src_m, replaces="s2anet_tpu/models/bn.py:140",
             launches=train_launches["s2a_bn_dx"], path="train", **bn_rows["dx"]),
    ]
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
