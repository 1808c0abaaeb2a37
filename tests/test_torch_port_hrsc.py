"""Serving HRSC2016 from a training run with the port, on the CPU.

* ``eval/hrsc.py`` (``parse_hrsc_xml``, ``load_hrsc_ground_truth``,
  ``evaluate_hrsc``) against the JAX scorer on written Annotation XML, a
  missing field and a missing file included: equal objects, AP within
  1e-9.
* ``S2ANetPredictor`` on a training checkpoint (``weights/last`` of
  ``train/checkpoint.py``) takes its EMA weights, or its model's with
  ``use_ema=False``, each equal to a deploy file of those weights; a file
  of another layout fails naming its keys. ``val --no-ema`` and ``val`` on
  that checkpoint give different detections.
* ``predict --config configs/hrsc_r50.yaml`` serves 1 class ("ship") at
  800; typed flags still win.
* ``val``'s compute type is the config's ``train.dtype`` unless ``--dtype``
  is typed.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from s2anet_tpu.eval import hrsc as jax_hrsc
from s2anet_tpu_torch import predict, val
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.data import synth
from s2anet_tpu_torch.eval import hrsc
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np
from s2anet_tpu_torch.train import checkpoint
from s2anet_tpu_torch.train.optim import Optimizer
from s2anet_tpu_torch.train.state import ModelEMA

HRSC_CONFIG = Path(__file__).resolve().parents[1] / "configs" / "hrsc_r50.yaml"
SIZE = 128


def _xml(objs) -> str:
    body = "".join(
        "<HRSC_Object>" + "".join(f"<{k}>{v}</{k}>" for k, v in o.items()) + "</HRSC_Object>"
        for o in objs)
    return f"<HRSC_Image><HRSC_Objects>{body}</HRSC_Objects></HRSC_Image>"


def _hrsc_set(root, rng, n_img=6):
    """Annotation XML of ships (some difficult, one with an empty and one
    without a difficult field) and detections near them plus clutter."""
    root.mkdir(parents=True, exist_ok=True)
    dets, ids = [], [f"1000{i:02d}" for i in range(n_img)]
    for k, img in enumerate(ids[:-1]):  # the last image has no file
        objs = []
        for j in range(int(rng.integers(1, 6))):
            o = {"mbox_cx": rng.uniform(50, 900), "mbox_cy": rng.uniform(50, 600),
                 "mbox_w": rng.uniform(40, 300), "mbox_h": rng.uniform(10, 60),
                 "mbox_ang": rng.uniform(-np.pi / 2, np.pi / 2),
                 "difficult": int(rng.uniform() < 0.2)}
            if j == 1:
                o["difficult"] = ""
            if j == 2:
                del o["difficult"]
            objs.append(o)
            box = np.array([o[f] for f in ("mbox_cx", "mbox_cy", "mbox_w", "mbox_h",
                                           "mbox_ang")])
            for _ in range(int(rng.integers(0, 3))):
                noisy = box + rng.normal(size=5) * [4, 4, 6, 3, 0.05]
                dets.append((img, float(rng.uniform(0.05, 1)),
                             rbox_vertices_np(noisy[None])[0].reshape(8)))
        (root / f"{img}.xml").write_text(_xml(objs))
        for _ in range(3):
            clutter = np.array([rng.uniform(0, 900), rng.uniform(0, 600), 80, 20, 0.3])
            dets.append((img, float(rng.uniform(0.05, 0.6)),
                         rbox_vertices_np(clutter[None])[0].reshape(8)))
    return ids, dets


@pytest.mark.parametrize("use_07", [True, False])
def test_hrsc_scorer_matches_jax(tmp_path, rng, use_07):
    ids, dets = _hrsc_set(tmp_path / "Annotation", rng)
    for img in ids[:-1]:
        got = hrsc.parse_hrsc_xml(tmp_path / "Annotation" / f"{img}.xml")
        want = jax_hrsc.parse_hrsc_xml(tmp_path / "Annotation" / f"{img}.xml")
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["difficult"] == w["difficult"] and g["name"] == w["name"] == "ship"
            np.testing.assert_array_equal(g["rbox"], w["rbox"])
            np.testing.assert_array_equal(g["poly"], w["poly"])
    gt = hrsc.load_hrsc_ground_truth(tmp_path / "Annotation", ids)
    ref = jax_hrsc.load_hrsc_ground_truth(tmp_path / "Annotation", ids)
    assert gt.keys() == ref.keys() and gt[ids[-1]] == []
    assert [d for _, d in sum(gt.values(), [])] == [d for _, d in sum(ref.values(), [])]
    got = hrsc.evaluate_hrsc(dets, tmp_path / "Annotation", ids, use_07_metric=use_07)
    want = jax_hrsc.evaluate_hrsc(dets, tmp_path / "Annotation", ids, use_07_metric=use_07)
    assert abs(got["ap"] - want["ap"]) <= 1e-9 and 0.2 < got["ap"] < 1
    assert got["npos"] == want["npos"]
    np.testing.assert_allclose(got["rec"], want["rec"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["prec"], want["prec"], rtol=0, atol=1e-12)
    assert hrsc.HRSC_CLASSES == jax_hrsc.HRSC_CLASSES


# ------------------------------------------------ training checkpoints


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A ``weights/last`` whose EMA differs from the model, the deploy files
    of both, and two synthetic val chips."""
    root = tmp_path_factory.mktemp("ckpt")
    model = S2ANet("resnet18", 3)
    model.init_weights(torch.Generator().manual_seed(0))
    ema = ModelEMA(model)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
                   * 0.05)
    opt = Optimizer(model, lambda _: 0.01)
    checkpoint.save_checkpoint(root / "weights" / "last", model, ema, opt, 0.5, 3)
    torch.save(model.state_dict(), root / "model.pt")
    checkpoint.strip_for_deploy(ema, root / "weights" / "deploy")
    synth.write_split(root / "val", 2, np.random.default_rng(1), SIZE, 3, 3)
    return root


def _weights(pred):
    return {k: v.clone() for k, v in pred.model.state_dict().items()}


def test_predictor_loads_training_checkpoint(run):
    cfg = ModelConfig(backbone="resnet18", num_classes=3)

    def load(path, **kw):
        return _weights(predict.S2ANetPredictor(cfg, str(path), device="cpu",
                                                dtype=torch.float32, **kw))

    last = run / "weights" / "last"
    with_ema, without = load(last), load(last, use_ema=False)
    for a, b in ((with_ema, load(run / "weights" / "deploy")),
                 (without, load(run / "model.pt")),
                 (load(run / "weights" / "deploy", use_ema=False), with_ema)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(with_ema[k], without[k]) for k in with_ema)
    torch.save({"params": {"w": torch.zeros(1)}, "step": 3}, run / "other.pt")
    with pytest.raises(ValueError, match=r"\['params', 'step'\]"):
        load(run / "other.pt")


def test_val_no_ema_on_training_checkpoint(run, tmp_path):
    args = ["--device", "cpu", "--backbone", "resnet18", "--num-classes", "3",
            "--img-size", str(SIZE), "--batch-size", "2", "--conf-thres", "0.005",
            "--dtype", "float32", "--data-root", str(run / "val" / "images"),
            "--weights", str(run / "weights" / "last")]
    outs = {}
    for name, extra in (("ema", []), ("model", ["--no-ema"]), ("deploy", None)):
        a = list(args)
        if extra is None:
            a[-1] = str(run / "weights" / "deploy")
            extra = []
        outs[name] = val.main(a + extra + ["--save-dir", str(tmp_path / name)])

    def lines(name):
        return sorted(f.read_text() for f in (tmp_path / name / "chip_results").glob("*.txt"))

    assert outs["ema"]["n_images"] == outs["model"]["n_images"] == 2
    assert sum(len(d) for d in outs["ema"]["chip_dets"].values()) > 0
    assert lines("ema") == lines("deploy") and lines("ema") != lines("model")


# ------------------------------------------------ CLI configuration


class _Stop(Exception):
    pass


def test_predict_config_hrsc(monkeypatch, tmp_path):
    """``--config configs/hrsc_r50.yaml``: 1 class at 800, windows of 800;
    a typed flag replaces the config's value."""
    seen = {}

    class Fake:
        device = torch.device("cpu")

        def __init__(self, cfg, weights, device, dtype, seed, use_ema=True):
            seen.update(cfg=cfg, use_ema=use_ema, dtype=dtype)

    def serve(pred, inputs, img_size, gap, batch_size, iou_thr, timing=None):
        seen.update(img_size=img_size, gap=gap, first=next(iter(inputs))[1].shape)
        timing.update(model=0.0, merge=0.0)
        return iter(())

    monkeypatch.setattr(predict, "S2ANetPredictor", Fake)
    monkeypatch.setattr(predict, "serve_chips", serve)
    predict.main(["--synthetic", "1", "--config", str(HRSC_CONFIG), "--no-ema",
                  "--save-dir", str(tmp_path)])
    assert seen["cfg"].num_classes == 1 and seen["cfg"].backbone == "resnet50"
    assert seen["img_size"] == 800 and seen["first"] == (800, 800, 3) and seen["gap"] == 200
    assert seen["cfg"].score_thr == seen["cfg"].predict_score_thr == 0.3
    assert seen["use_ema"] is False and seen["dtype"] == torch.bfloat16
    predict.main(["--synthetic", "1", "--config", str(HRSC_CONFIG), "--img-size", "256",
                  "--backbone", "resnet18", "--conf", "0.1", "--names", "dota",
                  "--save-dir", str(tmp_path)])
    assert seen["img_size"] == 256 and seen["cfg"].backbone == "resnet18"
    assert seen["cfg"].score_thr == 0.1 and seen["cfg"].num_classes == 15
    assert seen["use_ema"] is True


def test_predict_config_hrsc_writes_ships(tmp_path, capsys):
    """A real run of the HRSC config cut to R-18 at 128: one class, named
    ship with ``--names hrsc``; from the config alone it is ``0``, as the
    repository's ``predict.py`` names it (``--names``, else the DOTA list,
    else the class indices)."""
    for names, want in (("hrsc", "ship"), ("", "0")):
        save = tmp_path / (names or "none")
        summary = predict.main(["--synthetic", "1", "--config", str(HRSC_CONFIG),
                                "--backbone", "resnet18", "--img-size", str(SIZE),
                                "--device", "cpu", "--dtype", "float32", "--conf", "0.005",
                                "--save-dir", str(save)] + (["--names", names] if names else []))
        lines = (save / "synthetic_0000.txt").read_text().splitlines()
        assert summary["detections"] == len(lines) > 0
        assert {line.split()[0] for line in lines} == {want}
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary


@pytest.mark.parametrize("cfg_dtype,flag,want", [
    ("float32", None, torch.float32),
    ("float32", "bfloat16", torch.bfloat16),
    (None, None, torch.bfloat16),
    ("bfloat16", "float32", torch.float32),
])
def test_val_dtype_follows_config(tmp_path, monkeypatch, cfg_dtype, flag, want):
    """The JAX runner computes in ``cfg.train.dtype``; so does ``val`` unless
    ``--dtype`` is typed."""
    seen = []

    def fake(cfg, weights, device, dtype, seed, use_ema=True):
        seen.append(dtype)
        raise _Stop

    monkeypatch.setattr(val, "S2ANetPredictor", fake)
    args = ["--data-root", str(tmp_path), "--device", "cpu"]
    if cfg_dtype:
        (tmp_path / "config.yaml").write_text(f"train: {{dtype: {cfg_dtype}}}\n")
        args += ["--config", str(tmp_path / "config.yaml")]
    if flag:
        args += ["--dtype", flag]
    with pytest.raises(_Stop):
        val.main(args)
    assert seen == [want]
