"""Checkpoints and resume of the port's trainer, on the CPU in float32.

Two epochs straight equal one epoch, an interruption, ``--resume
weights/last`` and the second epoch, bit for bit: parameters, BN
statistics, EMA, momentum buffers, counts, best fitness and the
``results.csv`` rows (all but the wall time). The deploy weights load into
``S2ANetPredictor`` and give the EMA module's detections; ``--resume``
restores the accumulation state; ``increment_path`` and
``get_latest_run`` equal the JAX functions; a torchvision-layout ResNet
``state_dict`` loads into the backbone as the JAX package's
``load_pretrained_backbone`` loads it.
"""

import csv
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.torch_import import load_pretrained_backbone as jax_pretrained
from s2anet_tpu.train import checkpoint as jax_ckpt
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.data import synth
from s2anet_tpu_torch.models.convert import state_dict_from_jax
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.predict import S2ANetPredictor
from s2anet_tpu_torch.train import checkpoint
from s2anet_tpu_torch.train.__main__ import main
from s2anet_tpu_torch.train.pretrained import load_pretrained_backbone
from s2anet_tpu_torch.utils.callbacks import Callbacks

SIZE = 128
CFG = """model: {backbone: resnet18, num_classes: 3, max_per_img: 50, pre_nms_cap: 256, \
max_before_nms_per_level: 100, align_offset_clamp: 6.0}
data: {img_size: 128, max_gt: 8, names: [a, b, c], flipud: 0.5, hsv_v: 0.3}
train: {warmup_iters: 2, epochs: 2, ema_ramp_updates: 3}
eval: {batch_size: 2, use_07_metric: false}
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    rng = np.random.default_rng(0)
    synth.write_split(root / "train", 4, rng, SIZE, 3, 3)
    synth.write_split(root / "val", 2, rng, SIZE, 3, 3)
    (root / "cfg.yaml").write_text(CFG)
    return root


def _args(data, save_dir, *extra):
    return ["--config", str(data / "cfg.yaml"), "--data-root", str(data / "train/images"),
            "--val-root", str(data / "val/images"), "--batch-size", "2",
            "--dtype", "float32", "--device", "cpu", "--save-dir", str(save_dir),
            "--noplots", *extra]


def _rows(save_dir):
    with open(save_dir / "results.csv", newline="") as f:
        return [{k: v for k, v in r.items() if k != "time/epoch_s"} for r in csv.DictReader(f)]


class _Stop(Exception):
    pass


def test_resume_equals_straight_run_bit_for_bit(data, tmp_path):
    straight = main(_args(data, tmp_path / "a"))
    stop = Callbacks()
    starts = []

    def interrupt():
        starts.append(1)
        if len(starts) == 2:
            raise _Stop  # killed as epoch 1 begins: weights/last holds epoch 0
    stop.register_action("on_train_epoch_start", callback=interrupt)
    with pytest.raises(_Stop):
        main(_args(data, tmp_path / "b"), callbacks=stop)
    resumed = main(_args(data, tmp_path / "b", "--resume", str(tmp_path / "b/weights/last")))
    assert resumed["steps"] == 2 and resumed["updates"] == straight["updates"] == 4
    assert _rows(tmp_path / "a") == _rows(tmp_path / "b")
    assert len(_rows(tmp_path / "a")) == 2
    for name in ("last", "best", "deploy"):
        a = torch.load(tmp_path / "a/weights" / name, weights_only=True)
        b = torch.load(tmp_path / "b/weights" / name, weights_only=True)
        if name == "deploy":
            a, b = {"ema": a}, {"ema": b}
        assert a.keys() == b.keys()
        for part in a:
            if part in ("model", "ema"):
                for k in a[part]:
                    assert torch.equal(a[part][k], b[part][k]), (name, part, k)
            elif part == "optimizer":
                oa, ob = a[part], b[part]
                assert (oa["count"], oa["micro"]) == (ob["count"], ob["micro"]) == (4, 4)
                assert all(torch.equal(x, y) for x, y in zip(oa["momentum"], ob["momentum"]))
                assert all(x.numel() for x in oa["momentum"])
            else:
                assert a[part] == b[part], (name, part)
    meta = json.loads((tmp_path / "a/weights/last.meta.json").read_text())
    assert meta["epoch"] == 1


def test_deploy_weights_serve(data, tmp_path):
    main(_args(data, tmp_path / "r", "--epochs", "1"))
    deploy = tmp_path / "r/weights/deploy"
    sd = torch.load(deploy, weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    cfg = ModelConfig(backbone="resnet18", num_classes=3, max_per_img=50, pre_nms_cap=256,
                      max_before_nms_per_level=100, align_offset_clamp=6.0, fold_bn=False)
    pred = S2ANetPredictor(cfg, weights=str(deploy), device="cpu", dtype=torch.float32)
    ema = torch.load(tmp_path / "r/weights/last", weights_only=True)["ema"]
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, ema[k]), k
    boxes, _, _ = pred.predict(np.zeros((1, SIZE, SIZE, 3), np.uint8), score_thr=0.0)
    assert boxes.shape == (1, 50, 6) and torch.isfinite(boxes).all()


def test_resume_restores_accumulation(data, tmp_path):
    """--nbs 4 at batch 2: two micro-steps an update. An interrupted run
    resumed from weights/last ends where the straight run ends."""
    straight = main(_args(data, tmp_path / "a", "--nbs", "4"))
    assert straight["updates"] == 2 and straight["steps"] == 4
    stop = Callbacks()
    stop.register_action("on_model_save", callback=lambda: (_ for _ in ()).throw(_Stop()))
    with pytest.raises(_Stop):
        main(_args(data, tmp_path / "b", "--nbs", "4"), callbacks=stop)
    main(_args(data, tmp_path / "b", "--nbs", "4", "--resume",
               str(tmp_path / "b/weights/last")))
    a = torch.load(tmp_path / "a/weights/last", weights_only=True)
    b = torch.load(tmp_path / "b/weights/last", weights_only=True)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert _rows(tmp_path / "a") == _rows(tmp_path / "b")


def test_increment_path_and_latest_run_match_jax(tmp_path):
    runs = tmp_path / "runs"
    for name in ("exp", "exp2", "exp4", "other"):
        (runs / name / "weights").mkdir(parents=True)
    for i, name in enumerate(("exp2", "exp", "other")):
        f = runs / name / "weights" / "last"
        f.write_text("x")
        os.utime(f, (time.time() + i, time.time() + i))
    for p in ("exp", "exp4", "other", "new", "exp/sub"):
        for ok in (False, True):
            assert checkpoint.increment_path(runs / p, ok) == jax_ckpt.increment_path(runs / p, ok)
    assert checkpoint.get_latest_run(runs) == jax_ckpt.get_latest_run(runs)
    assert checkpoint.get_latest_run(runs).endswith("other/weights/last")
    assert checkpoint.get_latest_run(tmp_path / "none") == jax_ckpt.get_latest_run(
        tmp_path / "none") == ""


def _torchvision_resnet18(seed):
    """A seeded state dict in torchvision's ResNet-18 key layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {"conv1.weight": torch.randn(64, 3, 7, 7, generator=g)}

    def bn(prefix, c):
        sd[prefix + ".weight"] = torch.rand(c, generator=g) + 0.5
        sd[prefix + ".bias"] = torch.randn(c, generator=g)
        sd[prefix + ".running_mean"] = torch.randn(c, generator=g)
        sd[prefix + ".running_var"] = torch.rand(c, generator=g) + 0.5
        sd[prefix + ".num_batches_tracked"] = torch.tensor(7)
    bn("bn1", 64)
    cin = 64
    for stage, planes in enumerate((64, 128, 256, 512), start=1):
        for b in range(2):
            p = f"layer{stage}.{b}"
            stride = 2 if stage > 1 and b == 0 else 1
            sd[p + ".conv1.weight"] = torch.randn(planes, cin, 3, 3, generator=g)
            bn(p + ".bn1", planes)
            sd[p + ".conv2.weight"] = torch.randn(planes, planes, 3, 3, generator=g)
            bn(p + ".bn2", planes)
            if stride != 1 or cin != planes:
                sd[p + ".downsample.0.weight"] = torch.randn(planes, cin, 1, 1, generator=g)
                bn(p + ".downsample.1", planes)
            cin = planes
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def test_pretrained_backbone_matches_jax(tmp_path):
    path = tmp_path / "resnet18-tv.pth"
    torch.save(_torchvision_resnet18(3), path)
    jm = JaxS2ANet(backbone_name="resnet18", num_classes=3)
    variables = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    bb_params, bb_stats = jax_pretrained(str(path), "resnet18")
    variables = {"params": dict(variables["params"], backbone=bb_params),
                 "batch_stats": dict(variables["batch_stats"], backbone=bb_stats)}
    want = state_dict_from_jax(variables, "resnet18")

    model = S2ANet("resnet18", 3)
    model.init_weights(torch.Generator().manual_seed(0))
    n = load_pretrained_backbone(model, str(path), "resnet18")
    got = model.state_dict()
    keys = [k for k in got if k.startswith("backbone.") and "num_batches" not in k]
    assert n == len(keys) > 0
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    bad = _torchvision_resnet18(3)
    del bad["layer2.0.conv1.weight"]
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="missing"):
        load_pretrained_backbone(model, str(tmp_path / "bad.pth"), "resnet18")
    with pytest.raises(FileNotFoundError, match="auto"):
        load_pretrained_backbone(model, "auto", "resnet152")
