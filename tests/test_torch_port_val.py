"""The port's evaluation slice end to end against the JAX package, on the
CPU at a small size (R-18, 128x128 chips, float32).

* ``python -m s2anet_tpu_torch.val --device cpu`` on 4 DOTA-format chips
  against the JAX ``evaluate_on_chips`` on the same seeded weights (the
  port reads them from the ``.npz`` of the JAX variables). The chips'
  labels are the JAX model's own top detections, so mAP is far from 0:
  detections per chip match at least 95% 1:1 and map50 is within 0.02.
* ``python -m s2anet_tpu_torch.predict --mode chips`` on a 300 x 200
  scene (window 128, gap 32) against the JAX ``predict.py`` tiling and
  merge (``_predict_chips``) fed the port's per-window detections: the
  same windows and the same merged detections, line for line.
* ``val --cache packed`` reads a packed shard the JAX package built.
"""

import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.data.dota import DotaDataset as JaxDataset
from s2anet_tpu.eval.runner import evaluate_on_chips
from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.fold import fold_bn_for_eval
from s2anet_tpu.ops.polyiou_ref import rbox_vertices_np
from s2anet_tpu.parallel.step import make_eval_step
from s2anet_tpu.train.optim import build_optimizer
from s2anet_tpu.train.state import create_train_state
from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import predict, val
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.data import dota
from s2anet_tpu_torch.models.convert import save_jax_npz
from test_torch_port_data import make_dota_set

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import predict as jax_predict  # noqa: E402

SIZE = 128
N_GT = 20  # per chip: the JAX model's top detections inside the frame


def _variables(seed):
    """Seeded JAX R-18 variables with non-trivial BatchNorm statistics."""
    rng = np.random.default_rng(seed)
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15, deform_impl="gather")
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.2, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.8, 1.2, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return jmodel, {"params": variables["params"], "batch_stats": stats}


def _threshold(predictor, imgs, n=300):
    """The score that lets about ``n`` (box, class) pairs of image 0 through:
    random-weight scores sit near sigmoid(bias) = 0.01."""
    out = predictor.forward(predictor.to_input(imgs))
    scores = torch.cat([torch.sigmoid(c[0].reshape(-1)) for c in out["odm_cls"]])
    return float(scores.sort(descending=True).values[n])


def _chip_lines(save_dir):
    """{chip: [(class, score, centre)]} from the Task1 files of a run."""
    out = {}
    for f in sorted((Path(save_dir) / "chip_results").glob("Task1_*.txt")):
        cls = f.stem[len("Task1_"):]
        for line in f.read_text().splitlines():
            img, score, *coords = line.split()
            poly = np.array(coords, float).reshape(4, 2)
            out.setdefault(img, []).append((cls, float(score), poly.mean(0)))
    return out


def _matched(a, b):
    used = [False] * len(b)
    n = 0
    for ca, sa, pa in a:
        for j, (cb, sb, pb) in enumerate(b):
            if (not used[j] and ca == cb and abs(sa - sb) < 1e-3
                    and np.linalg.norm(pa - pb) < 1.0):
                used[j] = True
                n += 1
                break
    return n


@pytest.fixture(scope="module")
def val_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    make_dota_set(root / "set", np.random.default_rng(3), [(SIZE, SIZE)] * 4, n_obj=6)
    images = root / "set" / "images"
    jmodel, variables = _variables(1)
    save_jax_npz(root / "w.npz", variables)
    imgs = np.stack([np.load(p)[:, :, ::-1] for p in sorted(images.glob("*.npy"))])
    port = predict.S2ANetPredictor(ModelConfig(backbone="resnet18"), str(root / "w.npz"),
                                   device="cpu", dtype=torch.float32)
    thr = _threshold(port, imgs)

    jcfg = jax_config.load_config(None, {
        "model": {"backbone": "resnet18", "score_thr": thr},
        "data": {"img_size": SIZE}, "eval": {"batch_size": 2},
        "train": {"dtype": "float32"}})
    fmodel, folded = fold_bn_for_eval(jmodel, variables)
    tx = build_optimizer(lambda _: 0.0, params_example=folded["params"])
    state = create_train_state(folded["params"], folded["batch_stats"], tx)
    step = make_eval_step(fmodel, model_cfg=jcfg.model, compute_dtype=jnp.float32)
    # labels: the JAX model's own top detections that lie inside the chip
    outs = [step(state, jnp.asarray(imgs[i:i + 2] / np.float32(255))) for i in (0, 2)]
    boxes = np.concatenate([np.asarray(o[0]) for o in outs])
    labels = np.concatenate([np.asarray(o[1]) for o in outs])
    for i, p in enumerate(sorted(images.glob("*.png"))):
        polys = rbox_vertices_np(boxes[i, :, :5]).reshape(-1, 8)
        inside = (boxes[i, :, 5] > thr) & (polys >= 0).all(1) & (polys <= SIZE).all(1)
        keep = np.nonzero(inside)[0][:N_GT]
        assert len(keep) == N_GT
        (root / "set" / "labels" / f"{p.stem}.txt").write_text("".join(
            f"{labels[i, k]} " + " ".join(f"{v:.6f}" for v in polys[k] / SIZE) + "\n"
            for k in keep))

    want = evaluate_on_chips(fmodel, state, jcfg, save_dir=root / "jax", eval_step=step,
                             dataset=JaxDataset(images, img_size=SIZE, cache_images="disk"))
    got = val.main(["--device", "cpu", "--dtype", "float32", "--backbone", "resnet18",
                    "--img-size", str(SIZE), "--batch-size", "2", "--conf-thres", str(thr),
                    "--weights", str(root / "w.npz"), "--data-root", str(images),
                    "--save-dir", str(root / "port")])
    return root, got, want, thr


def test_val_matches_jax(val_runs):
    root, got, want, _ = val_runs
    # the classes that have labels score near 1 (the rest have no positives)
    with_gt = [r for r in want["per_class"].values() if r["npos"]]
    assert with_gt and all(r["ap"] > 0.9 for r in with_gt) and want["map50"] > 0.1
    assert abs(got["map50"] - want["map50"]) <= 0.02
    assert got["n_images"] == want["n_images"] == 4
    port, ref = _chip_lines(root / "port"), _chip_lines(root / "jax")
    assert port.keys() == ref.keys() and len(port) == 4
    for chip in ref:
        assert len(ref[chip]) > 100
        assert _matched(port[chip], ref[chip]) >= 0.95 * max(len(port[chip]), len(ref[chip]))


def test_val_prints_classes_and_json(capsys, val_runs):
    root, _, _, thr = val_runs
    capsys.readouterr()
    out = val.main(["--device", "cpu", "--dtype", "float32", "--backbone", "resnet18",
                    "--img-size", str(SIZE), "--batch-size", "4", "--conf-thres", str(thr),
                    "--weights", str(root / "w.npz"), "--use-07-metric", "0",
                    "--data-root", str(root / "set" / "images"), "--names", "dota"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 15 + 2 and lines[0].startswith("plane ")
    last = json.loads(lines[-1])
    assert set(last) == {"map50", "precision", "recall", "images_per_sec"}
    assert last["map50"] == out["map50"] and 0 <= out["map50"] <= 1


def test_val_reads_a_pack_the_jax_package_built(val_runs, monkeypatch):
    """``val --cache packed`` on PNGs without sidecars reads the packed shard
    the JAX package built (cv2 decode), and gives the sidecar run's
    detections and mAP."""
    root, got, _, thr = val_runs
    packed = root / "packed"
    (packed / "images").mkdir(parents=True)
    shutil.copytree(root / "set" / "labels", packed / "labels")
    for p in sorted((root / "set" / "images").glob("*.png")):
        shutil.copy2(p, packed / "images" / p.name)
    JaxDataset(packed / "images", img_size=SIZE, cache_images="packed")
    assert (packed / "images" / "images.pack.bin").exists()

    def no_decode(path):
        raise AssertionError(f"{path} decoded: the pack was not read")

    monkeypatch.setattr(dota, "decode_image", no_decode)
    out = val.main(["--device", "cpu", "--dtype", "float32", "--backbone", "resnet18",
                    "--img-size", str(SIZE), "--batch-size", "2", "--conf-thres", str(thr),
                    "--weights", str(root / "w.npz"), "--data-root", str(packed / "images"),
                    "--cache", "packed", "--save-dir", str(root / "port_packed")])
    assert out["n_images"] == 4 and out["map50"] == got["map50"]
    for f in sorted((root / "port" / "chip_results").glob("Task1_*.txt")):
        assert (root / "port_packed" / "chip_results" / f.name).read_text() == f.read_text()


def test_predict_scene_matches_jax_tiling_and_merge(tmp_path, monkeypatch):
    scene = np.random.default_rng(4).integers(0, 256, (300, 200, 3), dtype=np.uint8)
    (tmp_path / "src").mkdir()
    np.save(tmp_path / "src" / "scene.npy", scene)
    cfg = ModelConfig(backbone="resnet18")
    probe = predict.S2ANetPredictor(cfg, device="cpu", dtype=torch.float32, seed=7)
    thr = _threshold(probe, scene[None, :SIZE, :SIZE], 200)

    calls = []
    real = predict.S2ANetPredictor.predict

    def record(self, imgs, **kw):
        out = real(self, imgs, **kw)
        calls.append((np.array(imgs), [t.numpy().copy() for t in out]))
        return out

    monkeypatch.setattr(predict.S2ANetPredictor, "predict", record)
    summary = predict.main(["--source", str(tmp_path / "src"), "--npy", "--img-size", str(SIZE),
                            "--gap", "32", "--batch-size", "2", "--backbone", "resnet18",
                            "--device", "cpu", "--dtype", "float32", "--seed", "7",
                            "--conf", str(thr), "--save-dir", str(tmp_path / "out")])
    assert summary["images"] == 1 and summary["chips"] == 6 and len(calls) == 3

    fed = iter(calls)

    def step(state, imgs):
        chips, out = next(fed)
        np.testing.assert_array_max_ulp(imgs, chips.astype(np.float32) / 255.0, maxulp=1)
        return out

    opt = SimpleNamespace(img_size=SIZE, gap=32, batch_size=2, iou_thres=0.5)
    dets = jax_predict._predict_chips(None, None, None, scene[:, :, ::-1], "scene", opt, step)
    names = jax_config.DOTA10_CLASSES
    want = [f"{names[c]} {s:.4f} " + " ".join(f"{v:.2f}" for v in np.asarray(p).reshape(8))
            for c, s, p in dets]
    got = (tmp_path / "out" / "scene.txt").read_text().splitlines()
    assert got == want
    n_chip = sum(int(out[2].sum()) for _, out in calls)
    assert 50 < len(got) < n_chip  # the merge removed cross-window duplicates


def test_val_and_scene_serving_without_a_card_raise(tmp_path):
    """Both entry points run on the card unless ``--device cpu`` is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "images").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        val.main(["--data-root", str(tmp_path / "images"), "--backbone", "resnet18"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--synthetic", "1", "--backbone", "resnet18"])
    with pytest.raises(SystemExit, match="--gt-dir"):
        val.main(["--data-root", str(tmp_path / "images"), "--no-map-split"])
