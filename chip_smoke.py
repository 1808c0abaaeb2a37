#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``s2anet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero before the
last line:

  1. card      name and power limit (nvidia-smi), torch and CUDA versions
  2. build     compile the CUDA kernels from csrc/ (nvcc), build seconds
  3. kernel 1  AlignConv forward vs its plain version: P3 shapes in bf16
               and in f32 (TF32 off), and 1x1 / 2x2 / odd maps with offsets
               that leave the image
  4. kernel 2  rotated IoU vs the plain version (random and degenerate
               boxes), NMS bitmask and keep masks vs the plain NMS
  5. main path python -m s2anet_tpu_torch.predict on 8 synthetic 1024x1024
               chips (R-50, 15 classes, bf16, folded BN, seeded weights),
               launch counts of every kernel; outputs finite with the right
               shapes; at score_thr 0.005 the kernel path against the plain
               path on the card, >= 95% of detections matched 1:1: in bf16
               by (label, score, rotated IoU >= 0.5), in float32 (TF32 off)
               by (label, score, centre within 1 px)
  6. times     chips/s at batch 8 (2 warm-up batches, 7 timed), peak device
               memory, each kernel against its plain version (CUDA events),
               and a profiler table of one batch (--out, default runs/chip_smoke/)

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH, SIZE, SEED = 8, 1024, 0


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


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` runs after one
    warm-up, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU")
    parser.add_argument("--out", default=str(ROOT / "runs" / "chip_smoke"),
                        help="directory for the predictions and the profile table")
    out_dir = Path(parser.parse_args(argv).out)

    import torch

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
    from s2anet_tpu_torch.models.head import decode_levels
    from s2anet_tpu_torch.ops import deform_conv as dc
    from s2anet_tpu_torch.ops import iou_rotated as iou
    from s2anet_tpu_torch.ops import nms_rotated as nms

    dev = torch.device("cuda", 0)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = card_line()

    say("== 1. card")
    say(f"   card: {card}")
    say(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"capability {torch.cuda.get_device_capability(0)}")

    say("== 2. build")
    for name in ("deform_conv", "iou_nms_rotated"):
        t0 = time.perf_counter()
        _ext.library(name)
        secs, log = _ext.build_log.get(name, (time.perf_counter() - t0, ""))
        say(f"   {name}: built in {secs:.1f} s")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                say(f"     {line.strip()}")

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

    boxes, labels, valid = clustered_candidates(torch, gen, BATCH, 4096, dev)
    keep_k = nms.nms_keep_cuda(boxes, labels, valid, 0.5)
    torch.cuda.synchronize()
    keep_p = nms.nms_keep_plain(boxes, labels, valid, 0.5)
    check(torch.equal(keep_k, keep_p) and keep_k.sum().item() < valid.sum().item(),
          f"NMS keep, 8 x 4096 clustered candidates: identical "
          f"({keep_k.sum().item()} kept of {valid.sum().item()} valid)")

    say("== 5. main path")
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
    nms.NMS_MASK(cbc.data_ptr(), clc.data_ptr(), cvc.data_ptr(), cfg.nms_iou_thr,
                 mask.data_ptr(), BATCH, k, stream)
    torch.cuda.synchronize()
    bits = unpack_mask(torch, mask, k)[:, :n, :n].triu(1)
    over = nms.overlap_plain(cb, cl, cv, cfg.nms_iou_thr, n)
    mask_diff = (bits != over).sum().item()
    keep_k = nms.nms_keep_cuda(cb, cl, cv, cfg.nms_iou_thr)
    keep_p = nms.nms_keep_plain(cb, cl, cv, cfg.nms_iou_thr)
    keep_diff = (keep_k != keep_p).sum().item()
    check(mask_diff == 0 and keep_diff == 0,
          f"main-path candidates ({n} valid of {k}): mask bits differing {mask_diff}, "
          f"keeps differing {keep_diff} ({int(over.sum())} suppressing pairs)")

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

    # AlignConv at the five levels' shapes of one batch
    levels = []
    for s in cfg.strides:
        hw = SIZE // s
        xl = torch.randn(BATCH, hw, hw, 256, generator=gen, device=dev).bfloat16()
        ol = (torch.randn(BATCH, hw, hw, 9, 2, generator=gen, device=dev) * 1.5).bfloat16()
        wl = (torch.randn(3, 3, 256, 256, generator=gen, device=dev) * 0.05).bfloat16()
        levels.append((xl, ol, wl))
    t_dk = cuda_ms(torch, lambda: [dc.deform_conv2d_cuda(*a) for a in levels], 10)
    t_dp = cuda_ms(torch, lambda: [dc.deform_conv2d_plain(*a) for a in levels], 3)
    t_p3 = cuda_ms(torch, lambda: dc.deform_conv2d_cuda(*levels[0]), 10)
    say(f"   deform_conv2d P3-P7 (one batch, bf16): kernel {t_dk:.3f} ms "
        f"(P3 alone {t_p3:.3f} ms, {2 * 8 * 128 * 128 * 9 * 256 * 256 / t_p3 / 1e9:.1f} "
        f"TFLOP/s), plain {t_dp:.3f} ms")

    def run_mask():
        nms.NMS_MASK(cbc.data_ptr(), clc.data_ptr(), cvc.data_ptr(), cfg.nms_iou_thr,
                     mask.data_ptr(), BATCH, k, stream)

    keep_buf = torch.empty(BATCH, k, dtype=torch.bool, device=dev)

    def run_sweep():
        nms.NMS_SWEEP(mask.data_ptr(), cvc.data_ptr(), keep_buf.data_ptr(), BATCH, k, stream)

    t_mk = cuda_ms(torch, run_mask, 10)
    t_sk = cuda_ms(torch, run_sweep, 10)
    t_mp = cuda_ms(torch, lambda: nms.overlap_plain(cb, cl, cv, cfg.nms_iou_thr, n), 2)
    t_sp = cuda_ms(torch, lambda: nms.sweep_plain(over, cv[:, :n]), 2)
    say(f"   NMS on the main path's candidates (8 x {k}, {n} valid max): mask kernel "
        f"{t_mk:.3f} ms vs plain overlap {t_mp:.3f} ms; sweep kernel {t_sk:.3f} ms "
        f"vs plain sweep {t_sp:.3f} ms")
    c0 = cb[0].contiguous()
    t_ik = cuda_ms(torch, lambda: iou.box_iou_rotated_cuda(c0, c0), 10)
    t_ip = cuda_ms(torch, lambda: iou.box_iou_rotated_plain(c0, c0), 2)
    say(f"   box_iou_rotated {k}x{k} (image 0's candidates): kernel {t_ik:.3f} ms, "
        f"plain {t_ip:.3f} ms (max |kernel - plain| {iou_err:.3g}; "
        f"not on the serving path, which runs the NMS kernels)")

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

    say(card)
    say(json.dumps({"kernels": [
        {"name": "deform_conv2d_fwd", "route": "cuda",
         "source": "s2anet_tpu_torch/csrc/deform_conv.cu",
         "replaces": "s2anet_tpu/ops/pallas/deform_kernel.py:195",
         "launches": launches["s2a_deform_conv2d_fwd"],
         "max_abs_err": deform_err, "ms": t_dk, "plain_ms": t_dp},
        {"name": "nms_rotated_mask", "route": "cuda",
         "source": "s2anet_tpu_torch/csrc/iou_nms_rotated.cu",
         "replaces": "s2anet_tpu/ops/pallas/iou_kernel.py:46",
         "launches": launches["s2a_nms_rotated_mask"],
         "max_abs_err": float(mask_diff > 0), "ms": t_mk, "plain_ms": t_mp},
        {"name": "nms_rotated_sweep", "route": "cuda",
         "source": "s2anet_tpu_torch/csrc/iou_nms_rotated.cu",
         "replaces": "s2anet_tpu/ops/nms_rotated.py:28",
         "launches": launches["s2a_nms_rotated_sweep"],
         "max_abs_err": float(keep_diff > 0), "ms": t_sk, "plain_ms": t_sp},
    ]}))
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
