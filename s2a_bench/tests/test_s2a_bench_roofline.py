"""The yardstick's arithmetic: kernel bounds at the main path's shapes
(PERF.md's kernel table) and the reference's FLOPs against the program's
own counter."""

from __future__ import annotations

import json

import pytest
import torch

from s2a_bench import flops, roofline
from s2a_bench.harness import HERE


def test_align_conv_bounds_at_batch_8_1024():
    lv = roofline.level_sizes(1024, 1024, (8, 16, 32, 64, 128))
    assert lv == [(128, 128), (64, 64), (32, 32), (16, 16), (8, 8)]
    fwd = roofline.bound_s(*roofline.align_fwd(8, lv), roofline.BF16_FLOP_S)
    bwd = roofline.bound_s(*roofline.align_bwd(8, lv), roofline.BF16_FLOP_S)
    assert 1e3 * fwd == pytest.approx(0.208, abs=5e-4)   # PERF.md: 0.208 ms by operations
    assert 1e3 * bwd == pytest.approx(0.416, abs=1e-3)   # PERF.md: 0.416 ms by operations


def test_level_sizes_round_up():
    assert roofline.level_sizes(800, 800, (8, 16, 32, 64, 128)) == [
        (100, 100), (50, 50), (25, 25), (13, 13), (7, 7)]


def test_bn_bytes_of_a_train_step_at_batch_8_1024():
    shapes = roofline.bn_shapes("resnet50", 8, 1024, 1024)
    assert len(shapes) == 53
    t = roofline.bound_s(roofline.bn_train_bytes(shapes), 0, roofline.BF16_FLOP_S)
    # PERF.md: statistics 1.110 + gradient sums 2.219 + normalise 2.219 + dx 3.328 ms
    assert 1e3 * t == pytest.approx(1.110 + 2.219 + 2.219 + 3.328, rel=2e-3)


def test_nms_work_counts_the_pairs_these_candidates_need():
    # image 0: three valid boxes of one class, two of them overlapping
    # circles; a fourth of another class; the rest invalid
    boxes = torch.tensor([[[10., 10., 8., 8., 0.], [14., 10., 8., 8., 0.],
                           [100., 100., 8., 8., 0.], [12., 10., 8., 8., 0.],
                           [0., 0., 1., 1., 0.]]])
    labels = torch.tensor([[0, 0, 0, 1, 0]])
    valid = torch.tensor([[True, True, True, True, False]])
    nbytes, ops = roofline.nms_work(boxes, labels, valid)
    # same-label valid pairs j > i: (0,1) near, (0,2) far, (1,2) far
    assert ops == 1 * roofline.IOU_PAIR_OPS + 2 * roofline.IOU_REJECT_OPS
    cols = 1
    assert nbytes == 1 * 5 * 25 + 8 * 64 * cols + 8 * 5 + 2 * 5


@pytest.mark.parametrize("name", ["s2anet_r50_fpn_dota"])
def test_reference_flops_against_the_programs_counter(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    ref = flops.reference_flops(cfg["model"], 1, 1024, 1024, train=False)
    # the program's utils/flops.py count of its serving forward (PR 17): 391.698 GFLOP
    assert ref / 1e9 == pytest.approx(391.698, rel=2e-3)
