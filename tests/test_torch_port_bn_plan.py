"""The BN sums kernel's grid on the CPU (``ops/moments.py::sums_plan``).

One launch of ``csrc/bn_moments.cu::channel_sums`` walks ``[rows, C]`` with
``chunks x groups`` blocks in clusters of 8 along the rows, and at most one
resident wave of them; tile ``t`` of ``sums_rows x 256/TX`` rows falls to
block ``t % chunks``. The workspace holds one ``[2, C]`` partial per cluster
and the tickets one counter per channel group. These tests hold the plan
to that for every BatchNorm input of the R-50 train step at 1024^2, batch
8, and for odd shapes.
"""

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.models.bn import BatchNorm2d
from s2anet_tpu_torch.models.resnet import ResNet
from s2anet_tpu_torch.ops import moments as mo

WAVES = [8 * 62, 8 * 77, 8 * 132]  # blocks of one wave at 4, 5 and 8 blocks an SM


@pytest.fixture(scope="module")
def r50_bn_inputs():
    """``(rows, C)`` of the 53 BatchNorm inputs, from a forward on the meta
    device (no memory, no compute)."""
    net = ResNet("resnet50").to("meta").eval()
    shapes = []
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, inp: shapes.append(tuple(inp[0].shape)))
    with torch.no_grad():
        net(torch.empty(8, 3, 1024, 1024, device="meta"))
    return [(n * h * w, c) for n, c, h, w in shapes]


def _tile_rows(c, dtype, pair):
    nvec = c // (8 if dtype == torch.bfloat16 else 4)
    return mo.sums_rows(pair) * (256 // min(nvec, 32)), -(-nvec // min(nvec, 32))


def _check_plan(rows, c, dtype, wave, pair):
    """The plan's invariants; returns ``(chunks, rows a tile)``."""
    chunks, groups = mo.sums_plan(rows, c, dtype, wave, pair)
    tile, want_groups = _tile_rows(c, dtype, pair)
    tiles = -(-rows // tile)
    assert groups == want_groups
    assert chunks >= mo.CLUSTER and chunks % mo.CLUSTER == 0
    assert chunks * groups <= max(wave, mo.CLUSTER * groups)  # at most one wave
    # the wave is full, or every block has at most one tile
    assert chunks * groups > wave - mo.CLUSTER * groups or chunks >= tiles
    # every cluster has a tile
    assert chunks - mo.CLUSTER < max(tiles, 1)
    return chunks, tile


def _covered_once(rows, chunks, tile):
    counts = np.zeros(rows, np.int64)
    for b in range(chunks):
        for t in range(b, -(-rows // tile), chunks):
            counts[t * tile:min((t + 1) * tile, rows)] += 1
    return bool((counts == 1).all())


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sums_plan_r50_shapes(r50_bn_inputs, dtype, wave, pair):
    assert len(r50_bn_inputs) == 53
    for rows, c in r50_bn_inputs:
        _check_plan(rows, c, dtype, wave, pair)
    rows, c = r50_bn_inputs[0]  # the stem: 2M rows, checked row by row
    assert (rows, c) == (8 * 512 * 512, 64)
    assert _covered_once(rows, *_check_plan(rows, c, dtype, wave, pair))


@pytest.mark.parametrize("rows", [1, 2, 7, 35, 105, 1000, 8193])
@pytest.mark.parametrize("c,dtype", [(4, torch.float32), (8, torch.bfloat16),
                                     (24, torch.float32), (264, torch.bfloat16),
                                     (2048, torch.bfloat16)])
def test_sums_plan_odd_shapes_cover_each_row_once(rows, c, dtype):
    for wave in WAVES:
        for pair in (False, True):
            assert _covered_once(rows, *_check_plan(rows, c, dtype, wave, pair))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sums_workspace_and_ticket_sizes(r50_bn_inputs, dtype):
    """One [2, C] float32 partial per cluster; a channel group per ticket,
    within the counters the wrappers keep per device."""
    for rows, c in r50_bn_inputs + [(1, 8), (35, 264), (8193, 4096)]:
        for wave in WAVES:
            chunks, groups = mo.sums_plan(rows, c, dtype, wave)
            assert mo.workspace_floats(chunks, c) == chunks // mo.CLUSTER * 2 * c
            assert 1 <= groups <= mo.TICKET_SLOTS
    # the largest R-50 input's workspace stays small beside its input
    rows, c = max(r50_bn_inputs, key=lambda rc: rc[0] * rc[1])
    chunks, _ = mo.sums_plan(rows, c, dtype, max(WAVES))
    assert 4 * mo.workspace_floats(chunks, c) < rows * c * dtype.itemsize / 1000
