"""Data-parallel training of the port on the CPU, over gloo, with no JAX.

Each world is two ranks started with the ``spawn`` start method (the
pytest process holds JAX's threads: no fork), joined through a ``file://``
store in the test's own directory (no port for two workers to collide on),
and ended by a join timeout, so that a deadlock fails the test instead of
hanging the suite.

* One ``BatchNorm2d`` in training, forward and backward, on two ranks of
  two images against one process on the four: full statistics and the
  sampled prefixes 1, 2 and 3 of the global batch (1: rank 1 has no
  statistics rows). Outputs, dx, dgamma, dbeta and the running statistics
  within 1e-5 of the largest value (the sums are added in another order);
  both ranks' dgamma, dbeta and running statistics equal bit for bit.
* ``calibrate`` on two ranks, each on its own batches, against one process
  over all of them: the same ranges, bit for bit.
* A global batch that does not divide over the ranks raises, in the step
  bench and in a training run.
* The step bench with frozen stages and without the ORConv (parameters
  that take no gradient, layers in inference mode) on two ranks against
  one process: the second step's loss items within 1e-5 (relative).
* ``torchrun --nproc_per_node 2 -m s2anet_tpu_torch.train`` for one epoch
  on synthetic chips: one results.csv row, one JSON summary, rank 0's
  files only, checkpoint keys without a ``module.`` prefix, and its
  ``weights/last`` resumed by one process for a second epoch.
"""

import csv
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from s2anet_tpu_torch import config
from s2anet_tpu_torch.data import synth
from s2anet_tpu_torch.models.bn import BatchNorm2d
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.models.fold import fold_bn
from s2anet_tpu_torch.ops import quant
from s2anet_tpu_torch.parallel import mesh
from s2anet_tpu_torch.train import __main__ as train_cli

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
BN_SHAPE = (4, 16, 6, 5)  # global batch of 4, 2 a rank
STATS_IMAGES = (0, 1, 2, 3)
OPTIONS_BENCH = ["--device", "cpu", "--backbone", "resnet18", "--img-size", "64",
                 "--batch-size", "4", "--steps", "2", "--warmup", "0", "--synthetic", "1",
                 "--dtype", "float32", "--frozen-stages", "1", "--no-orconv"]


def start_world(fn, *args):
    """Start ``fn(rank, *args)`` on ``WORLD`` spawned processes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r,) + args) for r in range(WORLD)]
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
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]


def join_group(rank: int, store: str) -> None:
    torch.set_num_threads(2)
    mesh.init_group("cpu", f"file://{store}", rank, WORLD)


def _bn_inputs():
    rng = np.random.default_rng(5)
    c = BN_SHAPE[1]
    x = torch.from_numpy(rng.normal(1.0, 2.0, BN_SHAPE).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=BN_SHAPE).astype(np.float32))
    state = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c),
             "running_mean": rng.normal(0, 0.2, c), "running_var": rng.uniform(0.5, 2.0, c)}
    return x, g, {k: torch.from_numpy(v.astype(np.float32)) for k, v in state.items()}


def _bn_run(x, g, state, k):
    """y, dx, dgamma, dbeta and the running statistics of one training
    step of the layer (statistics from the first ``k`` global images)."""
    bn = BatchNorm2d(BN_SHAPE[1], stats_images=k)
    bn.load_state_dict(dict(state, num_batches_tracked=torch.tensor(0)))
    bn.train()
    x = x.clone().requires_grad_()
    y = bn(x)
    y.backward(g)
    return {"y": y.detach(), "dx": x.grad, "dgamma": bn.weight.grad, "dbeta": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "tracked": bn.num_batches_tracked}


def _calib_model():
    model = S2ANet("resnet18", 15, align_offset_clamp=6.0)
    model.init_weights(torch.Generator().manual_seed(0))
    fold_bn(model.eval())
    return model


def _calib_batches():
    """Two global batches of two 64^2 images: rank r holds image r of each."""
    rng = np.random.default_rng(9)
    return [torch.from_numpy(rng.uniform(size=(WORLD, 3, 64, 64)).astype(np.float32))
            for _ in range(2)]


def _layer_world(rank, store, out):
    join_group(rank, store)
    b = BN_SHAPE[0] // WORLD
    part = slice(rank * b, (rank + 1) * b)
    x, g, state = _bn_inputs()
    res = {k: _bn_run(x[part], g[part], state, k) for k in STATS_IMAGES}
    with torch.no_grad():
        ranges = quant.calibrate(_calib_model(), [t[rank:rank + 1] for t in _calib_batches()],
                                 quant.QUANT_SCOPE_ALL)
    options = train_cli.main(OPTIONS_BENCH)["losses"]
    raised = []
    for argv in (["--device", "cpu", "--backbone", "resnet18", "--img-size", "64",
                  "--batch-size", "3", "--steps", "1", "--dtype", "float32"],
                 ["--device", "cpu", "--data-root", str(out), "--batch-size", "3",
                  "--save-dir", str(out / "never")]):
        with pytest.raises(ValueError, match="must divide over 2 processes"):
            train_cli.main(argv)
        raised.append(argv[-1])
    torch.save({"bn": res, "ranges": ranges, "raised": raised, "options": options},
               out / f"layer.{rank}.pt")
    mesh.shutdown()


@pytest.fixture(scope="module")
def layer_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp_layer")
    join_world(start_world(_layer_world, str(d / "store"), d), timeout=180)
    return [torch.load(d / f"layer.{r}.pt", weights_only=False) for r in range(WORLD)]


def _rel_to_max(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("k", STATS_IMAGES)
def test_bn_layer_two_ranks_match_one_process(layer_world, k):
    x, g, state = _bn_inputs()
    want = _bn_run(x, g, state, k)
    ranks = [w["bn"][k] for w in layer_world]
    for key in ("y", "dx"):
        got = torch.cat([r[key] for r in ranks])
        assert _rel_to_max(got, want[key]) <= 1e-5, key
    for key in ("dgamma", "dbeta", "running_mean", "running_var", "tracked"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key  # replicated
        assert _rel_to_max(ranks[0][key].double(), want[key].double()) <= 1e-5, key
    assert int(ranks[0]["tracked"]) == 1


def test_calibrate_two_ranks_equal_one_process(layer_world):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: the CPU convs' sums follow it
    with torch.no_grad():
        want = quant.calibrate(_calib_model(), [t[r:r + 1] for t in _calib_batches()
                                                for r in range(WORLD)], quant.QUANT_SCOPE_ALL)
    torch.set_num_threads(threads)
    for w in layer_world:
        got = w["ranges"]
        assert got.keys() == want.keys() and len(want) == 40  # R-18, every scope group
        for name, (lo, hi) in want.items():
            assert torch.equal(got[name][0], lo) and torch.equal(got[name][1], hi), name


def test_frozen_stages_without_orconv_two_ranks_match_one_process(layer_world):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    want = train_cli.main(OPTIONS_BENCH)["losses"]
    torch.set_num_threads(threads)
    for w in layer_world:
        np.testing.assert_allclose(w["options"], want, rtol=1e-5)


def test_batch_that_does_not_divide_raises(layer_world):
    for w in layer_world:
        assert len(w["raised"]) == 2  # the bench and a training run


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_torchrun_two_ranks_then_resume_in_one_process(tmp_path):
    data = tmp_path / "data"
    rng = np.random.default_rng(0)
    synth.write_split(data / "train", 8, rng, 128, 3, 3)
    synth.write_split(data / "val", 2, rng, 128, 3, 3)
    cfg = config.load_config(None, {
        "model": {"backbone": "resnet18", "num_classes": 3, "max_per_img": 50,
                  "pre_nms_cap": 256, "max_before_nms_per_level": 100},
        "data": {"root": str(data / "train/images"), "train_list": str(data / "train/images"),
                 "val_list": str(data / "val/images"), "img_size": 128, "max_gt": 8,
                 "workers": 1},
        "train": {"epochs": 1, "batch_size": 4, "dtype": "float32", "warmup_iters": 0,
                  "plots": False},
        "eval": {"batch_size": 2}})
    cfg.save(tmp_path / "cfg.yaml")
    run = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(WORLD), "-m", "s2anet_tpu_torch.train", "--config", str(tmp_path / "cfg.yaml"),
         "--device", "cpu", "--save-dir", str(run)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    summaries = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(summaries) == 1 and summaries[0]["ranks"] == WORLD, proc.stdout
    assert "data parallel: 2 ranks, backend gloo" in proc.stdout
    assert summaries[0]["steps"] == 2 and summaries[0]["updates"] == 2
    written = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
    # the last validation's Task1 files (rank 0 validates) and TensorBoard's
    assert any(p.startswith("chip_results/Task1_") for p in written)
    assert [p for p in written if not p.startswith(("events", "chip_results/"))] == [
        "config.yaml", "results.csv", "weights/best", "weights/best.meta.json",
        "weights/deploy", "weights/last", "weights/last.meta.json"], written
    rows = _csv(run / "results.csv")
    assert len(rows) == 1 and np.isfinite([float(rows[0][k]) for k in rows[0]
                                           if k.startswith(("train/", "val/"))]).all()
    ckpt = torch.load(run / "weights" / "last", weights_only=True)
    for part in ("model", "ema"):
        assert not any(k.startswith("module.") for k in ckpt[part])
    assert ckpt["optimizer"]["count"] == 2
    deploy = torch.load(run / "weights" / "deploy", weights_only=True)
    assert deploy.keys() == ckpt["ema"].keys()

    resumed = train_cli.main(["--config", str(tmp_path / "cfg.yaml"), "--device", "cpu",
                              "--epochs", "2", "--save-dir", str(run), "--resume",
                              str(run / "weights" / "last")])
    assert resumed["ranks"] == 1 and resumed["steps"] == 2 and resumed["updates"] == 4
    rows = _csv(run / "results.csv")
    assert [r["epoch_or_step"] for r in rows] == ["0", "1"]
