"""The int8 conv kernel's plan on the CPU (``ops/quant.py::conv_plan``).

One launch of ``csrc/int8_conv.cu::int8_conv_sm90`` covers ``[M, Cout]``
with tiles of ``BM x bn`` and walks K in stages of ``kb`` bytes, split over
``splits`` blocks of ``kper`` stages where the tiles alone are under one
wave; ``grid`` persistent blocks walk the ``tiles x splits`` units (unit
``u``: tile ``u // splits``, split ``u % splits``; tile ``t``: M tile
``t // ntn``, N tile ``t % ntn``, as ``unit_at`` in the kernel). A stride-1
conv reads A by TMA as one box of the output's pixels a tap (``amode`` 2)
when the boxes hold each tile's 128 consecutive pixels. These tests hold
the plan to that for every quantised conv of R-50 serving at 1024^2, batch
8, in the default and the full scope, and for odd shapes, and hold a numpy
model of the split-K int32 sums to ``int8_sums_plain``.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.models import head as head_mod
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.ops import quant as pq

WAVES = [132, 114, 78]  # SMs of an H100 SXM, an H100 PCIe, a smaller card
SCOPES = {"default": pq.QUANT_SCOPE_DEFAULT, "full": pq.QUANT_SCOPE_ALL}


@pytest.fixture(scope="module")
def r50_quant_convs():
    """``{scope: [(b, h, w, cin, cout, k, stride, pad, output bytes)]}``,
    one entry a quantised conv call of a bf16 serving batch, from a forward
    on the meta device (no memory, no compute; AlignConv stubbed)."""
    net = S2ANet("resnet50", 15).to("meta").eval()
    calls = {}

    def record(self, x, slot=0):
        if self.mode != "none":
            kh, _, cin, cout = self.quant_kernel().shape
            b, _, h, w = x.shape
            calls[scope].append((b, h, w, cin, cout, kh, self.stride[0], self.padding[0],
                                 x.element_size()))
        return self.float_forward(x)

    def deform(x, offsets, w):
        return torch.empty(x.shape[:-1] + (w.shape[-1],), dtype=x.dtype, device=x.device)

    for scope, groups in SCOPES.items():
        calls[scope] = []
        net.set_quant("calib", groups).cast(torch.bfloat16)
        with mock.patch.object(pq.QuantMixin, "quant_forward", record), \
                mock.patch.object(head_mod, "deform_conv2d", deform), torch.no_grad():
            net(torch.empty(8, 3, 1024, 1024, device="meta", dtype=torch.bfloat16))
    return calls


def _ceil(a, b):
    return -(-a // b)


def _units(plan):
    """``(m tile, n tile, stage begin, stage end, split)`` of every unit, as
    the kernel's ``unit_at`` decodes them."""
    out = []
    for u in range(plan.tiles * plan.splits):
        tile, split = divmod(u, plan.splits)
        mt, nt = divmod(tile, plan.ntn)
        s0 = split * plan.kper
        out.append((mt, nt, s0, min(s0 + plan.kper, plan.nk), split))
    return out


def _check_boxes(b, ho, wo, bw, bh):
    """Each 128-pixel tile of the ``(b, ho, wo)`` output is the box of
    ``bw x bh x 128/(bw*bh)`` pixels at its first pixel, in the box's row
    order (x fastest), as the kernel's 4-D TMA loads it."""
    bb = pq.BM // (bw * bh)
    assert bw * bh * bb == pq.BM and wo % bw == 0 and ho % bh == 0 and b % bb == 0
    m0 = np.arange(0, b * ho * wo, pq.BM)[:, None]
    r = np.arange(pq.BM)[None, :]
    b0, oy0, ox0 = m0 // (ho * wo), m0 % (ho * wo) // wo, m0 % wo
    pix = ((b0 + r // (bw * bh)) * ho + oy0 + r // bw % bh) * wo + ox0 + r % bw
    assert (pix == m0 + r).all()


def _check_plan(shape, wave):
    """The plan's invariants for ``shape``; returns the plan."""
    b, h, w, cin, cout, k, stride, pad, out_bytes = shape
    plan = pq.conv_plan(b, h, w, cin, cout, k, k, stride, pad, out_bytes, wave)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    m, kk = b * ho * wo, k * k * cin
    assert plan.bn in (64, 128, 256)
    assert plan.bn == 64 if cout <= 64 else plan.bn >= 128
    assert out_bytes == 2 or plan.bn <= 128  # a float32 tile of 256 leaves no ring
    box = pq.tile_box(b, ho, wo)
    if k == 1 and stride == 1 and pad == 0:
        assert (plan.amode, plan.kb) == (1, pq.BK)
    elif stride == 1 and out_bytes == 2 and cin % 32 == 0 and box:
        assert plan.amode == 2 and (plan.bw, plan.bh) == box
        assert plan.kb == max(d for d in (128, 64, 32) if cin % d == 0) == pq.stage_bytes(cin)
        _check_boxes(b, ho, wo, *box)
    else:
        assert (plan.amode, plan.kb) == (0, pq.BK)
    assert plan.ntn == _ceil(cout, plan.bn) and plan.tiles == _ceil(m, pq.BM) * plan.ntn
    assert plan.nk == _ceil(kk, plan.kb)
    # every split has a stage, every stage a split
    assert 1 <= plan.kper and (plan.splits - 1) * plan.kper < plan.nk <= plan.splits * plan.kper
    # K is split only under one wave of tiles, and then fills at most one
    assert plan.splits == 1 or plan.tiles * plan.splits <= wave
    assert plan.splits == 1 or plan.tiles < wave
    # persistent: at most one resident wave, every block with a unit
    assert plan.grid == min(plan.tiles * plan.splits, wave)
    # int32 is exact for the whole sum and every partial
    assert kk * 127 * 127 < 2 ** 31
    units = _units(plan)
    # the tiles cover M x Cout exactly once
    tiles = {(mt, nt) for mt, nt, _, _, _ in units}
    assert len(tiles) == plan.tiles
    assert tiles == {(i, j) for i in range(_ceil(m, pq.BM)) for j in range(plan.ntn)}
    for extent, size, idx in ((m, pq.BM, 0), (cout, plan.bn, 1)):
        counts = np.zeros(extent, np.int64)
        for t in {tl[idx] for tl in tiles}:
            counts[t * size:min((t + 1) * size, extent)] += 1
        assert (counts == 1).all()
    # each tile's split ranges cover K's bytes exactly once
    per_tile = {}
    for mt, nt, s0, s1, _ in units:
        c = per_tile.setdefault((mt, nt), np.zeros(kk, np.int64))
        c[s0 * plan.kb:min(s1 * plan.kb, kk)] += 1
    assert all((c == 1).all() for c in per_tile.values())
    # the blocks' walk u = block, + grid, ... takes every unit once
    walked = sorted(u for blk in range(plan.grid)
                    for u in range(blk, plan.tiles * plan.splits, plan.grid))
    assert walked == list(range(plan.tiles * plan.splits))
    # workspace and tickets of a split launch
    assert plan.workspace_ints == (plan.tiles * plan.splits * pq.BM * plan.bn
                                   if plan.splits > 1 else 0)
    assert plan.splits == 1 or plan.tiles <= pq.TICKET_SLOTS
    return plan


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_conv_plan_r50_serving_shapes(r50_quant_convs, scope, wave):
    calls = r50_quant_convs[scope]
    assert (len(calls), len(set(calls))) == ((100, 34) if scope == "default" else (125, 54))
    assert all(c[-1] == 2 for c in calls)  # bf16 serving
    plans = {c: _check_plan(c, wave) for c in set(calls)}
    if wave == 132:
        # the large shapes fill the card with 128 x 256 tiles; the FPN's P6
        # conv and the P5-P7 stacks split K; the 1x1 stride-1 convs read A
        # by TMA as [M, Cin], the stride-1 3x3 convs as boxes (Cin 64 and
        # the ODM class stack's 32 in stages of 64 and 32 bytes), the
        # stride-2 convs gather it
        assert plans[(8, 128, 128, 256, 256, 3, 1, 1, 2)][:2] == (256, 2)
        assert plans[(8, 32, 32, 2048, 256, 3, 2, 1, 2)].amode == 0
        assert plans[(8, 32, 32, 2048, 256, 3, 2, 1, 2)].splits > 1
        for hw in (8, 16):
            assert plans[(8, hw, hw, 256, 256, 3, 1, 1, 2)].splits > 1
        assert plans[(8, 256, 256, 64, 256, 1, 1, 0, 2)].amode == 1
        assert plans[(8, 256, 256, 64, 64, 3, 1, 1, 2)][1:5] == (2, 128, 1, 64)
        assert plans[(8, 128, 128, 32, 256, 3, 1, 1, 2)].kb == 32


ODD = [
    (2, 33, 31, 128, 128, 3, 2, 1, 2),      # ragged M
    (1, 5, 7, 16, 48, 3, 1, 1, 2),          # M < 64, Cin 16, K 144: a partial stage
    (1, 5, 7, 16, 48, 1, 1, 0, 2),          # K 16 by TMA
    (2, 8, 8, 32, 256, 3, 1, 1, 2),         # K 288
    (1, 1, 1, 256, 256, 3, 1, 1, 2),        # M = 1
    (2, 16, 16, 256, 5, 3, 1, 1, 4),        # Cout 5, float32
    (2, 16, 16, 256, 15, 1, 1, 0, 4),       # Cout 15, float32
    (8, 128, 128, 256, 15, 3, 1, 1, 2),     # Cout 15, many tiles
    (1, 16, 16, 2048, 256, 3, 2, 1, 2),     # K = 18432, split
    (8, 32, 32, 2048, 256, 3, 2, 1, 2),
    (4, 40, 40, 256, 200, 3, 1, 1, 4),      # float32, Cout 200
    (8, 64, 64, 1024, 2048, 1, 2, 0, 2),    # stride-2 1x1, gathered
    (8, 64, 64, 64, 256, 1, 1, 0, 2),       # tiles above one wave
    (2, 8, 8, 64, 128, 5, 1, 2, 2),         # 5x5: boxes of whole images, 64-byte stages
    (1, 256, 256, 64, 64, 3, 1, 1, 2),      # boxes of half rows
    (2, 16, 16, 96, 64, 3, 1, 1, 2),        # Cin 96: 32-byte stages
    (3, 8, 8, 256, 64, 3, 1, 1, 2),         # 64-pixel images, odd batch: gathered
]


@pytest.mark.parametrize("shape", ODD, ids=str)
def test_conv_plan_odd_shapes(shape):
    for wave in WAVES + [8, 1]:
        _check_plan(shape, wave)


def _im2col_zp(xq, k, stride, pad, zp):
    """int64 ``[M, k*k*Cin]`` rows (taps ky, kx, ci) padded with ``zp``."""
    b, h, w, c = xq.shape
    xp = np.pad(xq.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                constant_values=zp)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    cols = [xp[:, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    return np.concatenate(cols, -1).reshape(b * ho * wo, k * k * c)


def split_k_sums(xq, wq, zp, stride, pad, plan, rng):
    """The kernel's sums, modelled in numpy: each unit's int32 partial over
    its K range of its tile; a tile's partials added in a random order (as
    the last block to arrive adds them) in int32, minus corr; ``[M, Cout]``."""
    cout, k = wq.shape[0], wq.shape[1]
    a = _im2col_zp(xq, k, stride, pad, zp)
    wm = wq.reshape(cout, -1).astype(np.int64)
    m, kk = a.shape
    out = np.zeros((m, cout), np.int64)
    parts = {}
    for mt, nt, s0, s1, _ in _units(plan):
        rows = slice(mt * pq.BM, min((mt + 1) * pq.BM, m))
        chans = slice(nt * plan.bn, min((nt + 1) * plan.bn, cout))
        ks = slice(s0 * plan.kb, min(s1 * plan.kb, kk))
        p = a[rows, ks] @ wm[chans, ks].T
        assert np.abs(p).max() < 2 ** 31  # every partial is an int32
        parts.setdefault((rows.start, chans.start), []).append((rows, chans, p.astype(np.int32)))
    for group in parts.values():
        order = rng.permutation(len(group))
        acc = np.zeros(group[0][2].shape, np.int32)
        for i in order:
            acc = acc + group[i][2]  # int32: exact, and equal in any order
        out[group[0][0], group[0][1]] = acc
    corr = zp * wq.reshape(cout, -1).astype(np.int64).sum(1)
    return out - corr


@pytest.mark.parametrize("shape,wave", [
    ((2, 16, 16, 256, 256, 3, 1, 1), 132),   # P6-like: 9 splits of 2 stages
    ((1, 16, 16, 2048, 256, 3, 2, 1), 132),  # K = 18432
    ((2, 33, 31, 128, 96, 3, 2, 1), 132),    # ragged M and Cout
    ((1, 5, 7, 16, 48, 3, 1, 1), 8),         # a partial last stage
    ((2, 8, 8, 256, 15, 3, 1, 1), 132),      # Cout 15: one stage a split
    ((8, 8, 8, 32, 256, 3, 1, 1), 132),      # 32-byte stages, split
])
@pytest.mark.parametrize("codes", ["random", "saturated"])
def test_split_k_int32_sums_equal_plain(shape, wave, codes):
    b, h, w, cin, cout, k, stride, pad = shape
    rng = np.random.default_rng(0)
    if codes == "random":
        xq = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
        wq = rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8)
        zp = -77
    else:  # every product at +-127 * 127, zero point at the clip
        xq = rng.choice(np.array([-127, 127], np.int8), (b, h, w, cin))
        wq = rng.choice(np.array([-127, 127], np.int8), (cout, k, k, cin))
        zp = 127
    plan = pq.conv_plan(b, h, w, cin, cout, k, k, stride, pad, 2, wave)
    assert plan.splits > 1
    got = split_k_sums(xq, wq, zp, stride, pad, plan, rng)
    want = pq.int8_sums_plain(torch.from_numpy(xq), torch.from_numpy(wq).permute(1, 2, 3, 0),
                              torch.tensor(float(zp)), stride, pad)
    np.testing.assert_array_equal(got, want.reshape(-1, cout).numpy().astype(np.int64))


def test_int32_bound_of_the_largest_k():
    """K = 9 * 2048 (the FPN's P6 conv) is the largest of the model: the
    sum of 18432 products of +-127 codes and every partial fit int32."""
    assert 9 * 2048 * 127 * 127 < 2 ** 31 - 1
    plan = pq.conv_plan(8, 32, 32, 2048, 256, 3, 3, 2, 1, 2, 132)
    assert plan.splits > 1 and plan.kper * pq.BK * 127 * 127 < 2 ** 31
