"""Spatial serving of the port on the CPU: the image's height sharded over
gloo ranks (``parallel/rows.py``, ``parallel/spatial.py``,
``predict --mode spatial``), with no JAX.

Worlds are spawned (the pytest process holds JAX's threads: no fork), meet
at a ``file://`` store in the test's directory and are killed after a join
timeout; the worker functions live here, at module level, and import no
JAX (``test_torch_port_spatial_jax.py`` runs its port ranks through
:func:`run_world` and :func:`_detect_world`). Each rank compares with the
unsharded op computed in its own process, at its own thread count.

* (a) Every conv geometry of the model (7x7/2 p3, 3x3/1, 3x3/2, 1x1/1,
  1x1/2, through ``models/conv.py::Conv2d``), the ORConv's conv and the
  stem's max-pool, on 2 and 4 ranks, against the unsharded op's rows:
  within 1e-6 of the largest value in float32 (and printed: which ones
  are bit-equal). Measured on this suite's CPU: the 7x7/2 stem conv, the
  1x1 convs and the pool bit-equal, the 3x3 convs not (the block's height
  changes how the CPU conv sums).
* (b) The AlignConv's rows (``rows.deform_rows``) around the plain
  deformable conv: clamp 6 on shards taller than the halo (the halo
  exchange) and no taller (gathered), and clamp 0 (gathered), against the
  unsharded plain version's rows, within 1e-5 of the largest value.
* (c) Anchors and AlignConv offsets of a map starting at a later row equal
  those rows of the whole map's, bit for bit.
* A whole detector on 2 ranks against one process: the gathered head
  outputs and the detections.
* (e) The CLI: ``predict --mode spatial --device cpu`` alone and under
  ``torchrun --nproc_per_node 2`` writes the same lines; the padding rule;
  typed chips-mode flags and a quantised config are refused; the input is
  scaled as the repository's ``predict.py`` scales (``/ 255`` in float32),
  in both modes, and ``val``'s predictor keeps the loader's product.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from s2anet_tpu_torch import predict
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.models.anchors import grid_anchors
from s2anet_tpu_torch.models.conv import Conv2d
from s2anet_tpu_torch.models.head import S2ANetHead, s2anet_get_bboxes
from s2anet_tpu_torch.models.resnet import MaxPool2d
from s2anet_tpu_torch.ops.deform_conv import align_conv_offsets, deform_conv2d_plain
from s2anet_tpu_torch.parallel import mesh, rows, spatial

ROOT = Path(__file__).resolve().parent.parent
GEOMETRIES = [(7, 2, 3), (3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0)]  # (k, s, p)
TINY = ["--backbone", "resnet18", "--num-classes", "3", "--dtype", "float32",
        "--device", "cpu"]


def start_world(fn, world: int, *args):
    """Start ``fn(rank, world, *args)`` on ``world`` spawned processes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world) + args) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs, timeout: float) -> None:
    """Wait for every rank; kill them all and fail after ``timeout``
    seconds, or when a rank failed."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"the world did not finish within {timeout} s (deadlock?)"
    assert [p.exitcode for p in procs] == [0] * len(procs), [p.exitcode for p in procs]


def run_world(fn, world: int, tmp_path: Path, *args, timeout: float = 120.0) -> None:
    store = tmp_path / f"store{world}"
    join_world(start_world(fn, world, str(store), *args), timeout)


@pytest.fixture
def one_thread():
    """This process at one thread, as the ranks run; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def join_group(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    mesh.init_group("cpu", f"file://{store}", rank, world)


def _rows(t: torch.Tensor, rank: int, world: int, dim: int = 2) -> torch.Tensor:
    h = t.shape[dim] // world
    return t.narrow(dim, rank * h, h)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# (a) convolutions and the max-pool --------------------------------------------


def _ops_world(rank, world, store, out):
    join_group(rank, world, store)
    gen = torch.Generator().manual_seed(3)
    h, w, c = 32 * world, 20, 8  # 32 rows a rank: whole stride-2 rows
    x = torch.randn(1, c, h, w, generator=gen)
    res = {}
    for k, s, p in GEOMETRIES:
        conv = Conv2d(c, 6, k, s, p)
        with torch.no_grad():
            conv.weight.normal_(generator=gen)
            conv.bias.normal_(generator=gen)
            want = _rows(conv(x), rank, world)
            with rows.sharded():
                got = conv(_rows(x, rank, world))
        res[f"conv {k}x{k}/{s} p{p}"] = got, want
    wo = torch.randn(6, c, 3, 3, generator=gen)  # the ORConv's call
    want = _rows(F.conv2d(x, wo, padding=1), rank, world)
    with rows.sharded():
        got = rows.conv2d(_rows(x, rank, world), wo, None, 1, 1)
    res["orconv 3x3/1 p1"] = got, want
    pool = MaxPool2d(3, 2, 1)
    xr = torch.relu(x)  # the stem's pool follows a ReLU
    want = _rows(pool(xr), rank, world)
    with rows.sharded():
        got = pool(_rows(xr, rank, world))
    res["maxpool 3/2 p1"] = got, want
    torch.save(res, f"{out}/ops{rank}.pt")
    mesh.shutdown()  # the gloo threads end before the process does


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_convs_and_pool_match_unsharded(tmp_path, world):
    run_world(_ops_world, world, tmp_path, str(tmp_path))
    bit_equal = {}
    for r in range(world):
        for name, (got, want) in torch.load(tmp_path / f"ops{r}.pt").items():
            assert got.shape == want.shape, (name, r)
            assert _rel(got, want) <= 1e-6, (name, r, _rel(got, want))
            bit_equal[name] = bit_equal.get(name, True) and torch.equal(got, want)
    assert len(bit_equal) == len(GEOMETRIES) + 2
    print(f"bit-equal on {world} ranks:", bit_equal)


# (b) the AlignConv's rows -----------------------------------------------------


def _deform_world(rank, world, store, out):
    join_group(rank, world, store)
    gen = torch.Generator().manual_seed(4)
    weight = torch.randn(3, 3, 8, 8, generator=gen) * 0.1
    res = {}
    for clamp, per_rank in ((6.0, 16), (6.0, 4), (0.0, 16)):
        h = per_rank * world
        x = torch.randn(1, h, 12, 8, generator=gen)
        reach = clamp if clamp > 0 else 3.0 * per_rank  # unclamped: across shards
        off = (torch.rand(1, h, 12, 9, 2, generator=gen) * 2 - 1) * reach
        want = _rows(deform_conv2d_plain(x, off, weight), rank, world, 1)
        fn = lambda xs, os: deform_conv2d_plain(xs, os, weight)  # noqa: E731
        with rows.sharded():
            got = rows.deform_rows(fn, _rows(x, rank, world, 1), _rows(off, rank, world, 1),
                                   clamp)
        res[f"clamp {clamp}, {per_rank} rows a rank"] = got, want
    torch.save(res, f"{out}/deform{rank}.pt")
    mesh.shutdown()  # the gloo threads end before the process does


@pytest.mark.parametrize("world", [2, 4])
def test_alignconv_rows_match_unsharded(tmp_path, world):
    run_world(_deform_world, world, tmp_path, str(tmp_path))
    for r in range(world):
        for name, (got, want) in torch.load(tmp_path / f"deform{r}.pt").items():
            assert got.shape == want.shape, (name, r)
            assert _rel(got, want) <= 1e-5, (name, r, _rel(got, want))


def test_deform_rows_halo_or_gather():
    """The branch each shard takes: the halo above ``ceil(clamp) + 2``
    rows, else the whole level; every call of ``fn`` sees the block that
    branch says (one process standing for rank 0 of 2, its exchanges
    stubbed)."""
    seen = []

    def fn(x, off):
        seen.append((x.shape[1], off.shape[1]))
        return x

    def gather(t, dim):
        return torch.cat([t, t], dim)

    def halo(t, top, bottom, dim):
        return t[:, :top] * 0, t[:, :bottom]

    with mock.patch.object(mesh, "world_size", return_value=2), \
            mock.patch.object(mesh, "gather_rows", gather), \
            mock.patch.object(mesh, "halo_rows", halo), rows.sharded():
        for clamp, h in ((6.0, 9), (6.0, 8), (0.0, 64), (1.5, 5)):
            rows.deform_rows(fn, torch.zeros(1, h, 3, 2), torch.zeros(1, h, 3, 9, 2), clamp)
    assert seen == [(9 + 16, 9 + 16), (16, 16), (128, 128), (5 + 8, 5 + 8)]


# (c) absolute rows ------------------------------------------------------------


@pytest.mark.parametrize("stride,h,row0", [(8, 16, 16), (32, 4, 12), (128, 1, 3)])
def test_anchors_and_offsets_from_a_first_row(stride, h, row0):
    w, total = 6, row0 + 2 * h
    whole = grid_anchors((total, w), stride)
    part = grid_anchors((h, w), stride, row0=row0)
    np.testing.assert_array_equal(part, whole[row0 * w:(row0 + h) * w])
    head = S2ANetHead(num_classes=3, feat_channels=16)
    np.testing.assert_array_equal(head.level_anchors(h, w, stride, "cpu", row0).numpy(), part)
    rng = np.random.default_rng(row0)
    refined = torch.from_numpy(whole + rng.normal(0, 3, whole.shape).astype(np.float32))[None]
    want = align_conv_offsets(refined, (total, w), float(stride))[:, row0:row0 + h]
    got = align_conv_offsets(refined[:, row0 * w:(row0 + h) * w], (h, w), float(stride),
                             row0=row0)
    assert torch.equal(got, want)


# a whole detector on 2 ranks ---------------------------------------------------


def tiny_cfg(clamp: float) -> ModelConfig:
    return ModelConfig(backbone="resnet18", num_classes=3, align_offset_clamp=clamp,
                       max_per_img=32, pre_nms_cap=128, max_before_nms_per_level=64)


def detector(clamp: float, weights: str = "") -> predict.S2ANetPredictor:
    """The R-18 3-class float32 predictor on the CPU (``weights``: a file
    :func:`predict.load_state_dict` reads, or "" for random weights from
    seed 0), scaling as ``predict`` does."""
    return predict.S2ANetPredictor(tiny_cfg(clamp), weights, device="cpu",
                                   dtype=torch.float32, divide=True)


def _detect_world(rank, world, store, out, clamp, weights, img_path, thr):
    """``spatial_forward`` and the decode at ``thr`` of the R-18 3-class
    detector (``weights``: a state_dict file, or "" for seed 0) on this
    rank's rows of the image at ``img_path``; rank 0 saves them."""
    join_group(rank, world, store)
    pred = detector(clamp, weights)
    x = pred.to_input(spatial.shard_rows(np.load(img_path), rank, world))
    whole = spatial.spatial_forward(pred.forward, x)
    if rank == 0:
        dets = s2anet_get_bboxes(whole, **dict(pred.post_kwargs(), score_thr=thr))
        torch.save({"out": whole, "dets": dets}, f"{out}/dets.pt")
    mesh.shutdown()  # the gloo threads end before the process does


def gap_threshold(out, lo: int = 10, hi: int = 28) -> float:
    """A score threshold in the widest gap between the ``lo``-th and
    ``hi``-th highest (anchor, class) scores of the head outputs: between
    ``lo`` and ``hi`` candidates pass it, none of them near it."""
    scores = np.sort(np.concatenate(
        [torch.sigmoid(c.float()).reshape(-1).numpy() for c in out["odm_cls"]]))[::-1]
    i = lo + int(np.argmax(scores[lo - 1:hi - 1] - scores[lo:hi]))
    return float((scores[i - 1] + scores[i]) / 2)


@pytest.mark.parametrize("clamp", [0.0, 6.0])
def test_two_ranks_detect_as_one_process(tmp_path, clamp, one_thread):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (1, 256, 384, 3), dtype=np.uint8)
    np.save(tmp_path / "img.npy", img)
    pred = detector(clamp)
    with torch.no_grad():
        want_out = pred.forward(pred.to_input(img))
    thr = gap_threshold(want_out)
    want = s2anet_get_bboxes(want_out, **dict(pred.post_kwargs(), score_thr=thr))
    run_world(_detect_world, 2, tmp_path, str(tmp_path), clamp, "", str(tmp_path / "img.npy"),
              thr)
    got = torch.load(tmp_path / "dets.pt")
    for key in spatial.DECODED:
        for g, w in zip(got["out"][key], want_out[key]):
            assert g.shape == w.shape and _rel(g, w) <= 1e-4, (key, _rel(g, w))
    (gb, gl, gv), (wb, wl, wv) = got["dets"], want
    assert int(wv.sum()) >= 5
    assert torch.equal(gv, wv) and torch.equal(gl, wl)
    np.testing.assert_allclose(gb.numpy(), wb.numpy(), rtol=1e-4, atol=1e-3)


def test_one_rank_runs_the_forward_as_it_is():
    """Without a group the spatial step is the model's forward on the
    padded image: the same operators, as many of each (no halo, no copy),
    and the same outputs."""
    from torch.profiler import ProfilerActivity, profile

    pred = detector(6.0)
    x = pred.to_input(np.random.default_rng(5).integers(0, 256, (1, 256, 128, 3), np.uint8))
    pred.forward(x)  # the anchor grids, made once and cached
    ops, outs = [], []
    for fn in (lambda: pred.forward(x), lambda: spatial.spatial_forward(pred.forward, x)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outs.append(fn())
        ops.append({e.key: e.count for e in prof.key_averages()})
    assert ops[0] == ops[1] and len(ops[0]) > 20
    for a, b in zip(outs[0]["odm_cls"], outs[1]["odm_cls"]):
        assert torch.equal(a, b)


# (e) the CLI ------------------------------------------------------------------


def test_padded_size():
    assert spatial.padded_size(3000, 4000, 1) == (3072, 4096)
    assert spatial.padded_size(3000, 4000, 2) == (3072, 4096)
    assert spatial.padded_size(3000, 4000, 4) == (3072, 4096)
    assert spatial.padded_size(300, 100, 1) == (384, 128)
    assert spatial.padded_size(300, 100, 2) == (512, 128)
    assert spatial.padded_size(256, 256, 2) == (256, 256)
    with pytest.raises(ValueError, match="divide by ranks x max stride"):
        spatial.spatial_forward(lambda x: x, torch.zeros(1, 3, 200, 128))


def test_cli_spatial_alone_and_on_two_ranks(tmp_path, one_thread):
    """The same lines (as a multiset: near-tied scores print alike in any
    order) at a threshold in a gap of the scores, from a scene whose height
    pads to 256 on 1 and on 2 ranks."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(11)
    scene = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    np.save(src / "scene.npy", scene)
    pred = detector(0.0)
    padded = np.zeros((1, 256, 384, 3), np.uint8)
    padded[0, :200, :300] = scene
    with torch.no_grad():
        thr = gap_threshold(pred.forward(pred.to_input(padded)))
    common = ["--source", str(src), "--npy", "--mode", "spatial", "--conf", repr(thr), *TINY]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    runs = {}
    for ranks in (1, 2):
        launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", str(ranks)] if ranks > 1 else [sys.executable])
        save = tmp_path / f"out{ranks}"
        proc = subprocess.run(
            launcher + ["-m", "s2anet_tpu_torch.predict", *common, "--save-dir", str(save)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
        assert proc.returncode == 0, proc.stderr[-4000:]
        summaries = [json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith("{")]
        assert len(summaries) == 1, proc.stdout
        s = summaries[0]
        assert s["mode"] == "spatial" and s["ranks"] == ranks and s["images"] == 1
        assert s["model_seconds"] > 0 and s["decode_seconds"] >= 0
        runs[ranks] = sorted((save / "scene.txt").read_text().splitlines())
        assert len(runs[ranks]) == s["detections"] >= 5
    assert runs[1] == runs[2]


@pytest.mark.parametrize("flag", [["--gap", "100"], ["--img-size", "512"],
                                  ["--batch-size", "2"]])
def test_cli_spatial_refuses_chips_flags(flag, capsys):
    with pytest.raises(SystemExit):
        predict.parse_opt(["--synthetic", "1", "--mode", "spatial", *flag])
    assert "chips mode only" in capsys.readouterr().err
    opt = predict.parse_opt(["--synthetic", "1", *flag])  # chips mode takes them
    assert (opt.gap, opt.batch_size) != (None, None)


def test_cli_spatial_refuses_quant(tmp_path):
    cfg = tmp_path / "q.yaml"
    cfg.write_text("model: {backbone: resnet18, num_classes: 3, quant: int8}\n")
    with pytest.raises(ValueError, match="float only"):
        predict.main(["--synthetic", "1", "--mode", "spatial", "--config", str(cfg),
                      "--device", "cpu", "--save-dir", str(tmp_path / "o")])


@pytest.mark.parametrize("mode", ["chips", "spatial"])
def test_predict_scales_as_predict_py(tmp_path, mode):
    """The CLI's model input: each uint8 level divided by 255 in float32,
    as the repository's ``predict.py`` scales (one ulp apart from the
    product on 126 levels)."""
    levels = np.arange(256, dtype=np.uint8)
    img = np.broadcast_to(levels[:, None, None], (256, 128, 3)).copy()
    src = tmp_path / "src"
    src.mkdir()
    np.save(src / "levels.npy", img)
    seen = []
    real = predict.S2ANetPredictor.forward

    def forward(self, x):
        seen.append(x.clone())
        return real(self, x)

    argv = ["--source", str(src), "--npy", "--mode", mode, *TINY, "--save-dir",
            str(tmp_path / "o")]
    if mode == "chips":
        argv += ["--img-size", "256", "--batch-size", "1"]
    with mock.patch.object(predict.S2ANetPredictor, "forward", forward):
        predict.main(argv)
    x = seen[0][0, 0, :, 0].numpy()  # red channel, the first column: the 256 levels
    want = np.float32(levels) / 255.0
    assert not np.array_equal(want, levels.astype(np.float32) * np.float32(1 / 255))
    np.testing.assert_array_equal(x, want)


def test_predictor_scaling_rules():
    """``divide`` (predict): ``np.float32(x) / 255.0``; the default
    (``val``, as the JAX loader): the product with float32(1/255)."""
    levels = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    flat = np.arange(256, dtype=np.uint8)
    for divide, want in ((True, np.float32(flat) / 255.0),
                         (False, flat.astype(np.float32) * np.float32(1.0 / 255.0))):
        pred = detector(0.0)
        pred.divide = divide
        got = pred.to_input(levels)[0, 0].reshape(-1).numpy()
        np.testing.assert_array_equal(got, want)
    assert sum(np.float32(v) / 255.0 != np.float32(v) * np.float32(1 / 255)
               for v in range(256)) == 126
