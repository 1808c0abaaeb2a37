"""The port's ``tools``: ``visualize`` and ``quant_scope_bench``, on the CPU
at 64^2.

* ``visualize`` writes, per image, the PNG of the labels' boxes and the
  detections that ``utils/plots.draw_rboxes`` draws on the loader's image.
* ``quant_scope_bench --device cpu`` prints the float rate and one row per
  quantisation scope.
"""

import numpy as np
import torch

from s2anet_tpu_torch.config import DOTA10_CLASSES, ModelConfig
from s2anet_tpu_torch.data import synth
from s2anet_tpu_torch.data.dota import DotaDataset
from s2anet_tpu_torch.data.image import imread
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.predict import S2ANetPredictor
from s2anet_tpu_torch.tools import quant_scope_bench, visualize
from s2anet_tpu_torch.utils.plots import draw_rboxes

SIZE = 64


def test_visualize_draws_labels_and_detections(tmp_path):
    synth.main(["--out", str(tmp_path / "ds"), "--n-train", "3", "--n-val", "0",
                "--img-size", str(SIZE), "--num-classes", "2"])
    images = tmp_path / "ds" / "train" / "images"
    gen = torch.Generator().manual_seed(1)
    sd = S2ANet("resnet18", num_classes=2).init_weights(gen).state_dict()
    # scores spread over (0, 1), not within 1e-4 of the prior 0.01
    head = sd["head.odm_cls_head.weight"]
    sd["head.odm_cls_head.weight"] = torch.randn(head.shape, generator=gen) * 5.0
    sd["head.odm_cls_head.bias"] = torch.full((2,), -1.0)
    torch.save(sd, tmp_path / "w.pt")
    conf = 0.3
    written = visualize.main([
        "--data-root", str(images), "--out-dir", str(tmp_path / "vis"), "--weights",
        str(tmp_path / "w.pt"), "--num", "2", "--img-size", str(SIZE), "--conf", str(conf),
        "--backbone", "resnet18", "--num-classes", "2", "--names", "dota", "--device", "cpu"])
    assert [p.name for p in written] == [p.with_suffix(".png").name
                                         for p in sorted(images.glob("*.png"))[:2]]
    ds = DotaDataset(images, img_size=SIZE)
    pred = S2ANetPredictor(ModelConfig(backbone="resnet18", num_classes=2),
                           str(tmp_path / "w.pt"), device="cpu")
    names = ["0", "1"]  # the dota preset has 15 names, not 2
    drawn = 0
    for i, path in enumerate(written):
        s = ds.get_sample(i)
        m = s["gt_mask"]
        want = draw_rboxes(s["imgs"][:, :, ::-1], s["gt_boxes"][m], s["gt_classes"][m],
                           names=names)
        boxes, labels, valid = (t[0].numpy() for t in pred.predict(s["imgs"][None]))
        keep = valid & (boxes[:, 5] >= conf)
        drawn += int(keep.sum())
        want = draw_rboxes(want, boxes[keep][:, :5], labels[keep], boxes[keep][:, 5],
                           names=names)
        got = imread(path)  # BGR, as cv2.imread
        assert got.shape == (SIZE, SIZE, 3) and np.array_equal(got, want), path
        assert m.any() and (got != s["imgs"][:, :, ::-1]).any()
    assert 0 < drawn


def test_visualize_without_weights_draws_labels_only(tmp_path):
    synth.main(["--out", str(tmp_path / "ds"), "--n-train", "1", "--n-val", "0",
                "--img-size", str(SIZE)])
    images = tmp_path / "ds" / "train" / "images"
    (path,) = visualize.main(["--data-root", str(images), "--out-dir", str(tmp_path / "vis"),
                              "--img-size", str(SIZE), "--device", "cpu"])
    s = DotaDataset(images, img_size=SIZE).get_sample(0)
    m = s["gt_mask"]
    want = draw_rboxes(s["imgs"][:, :, ::-1], s["gt_boxes"][m], s["gt_classes"][m],
                       names=DOTA10_CLASSES)
    assert np.array_equal(imread(path), want)


def test_quant_scope_bench_prints_a_row_per_scope(capsys):
    rows = quant_scope_bench.main(["--device", "cpu", "--backbone", "resnet18", "--size",
                                   str(SIZE), "--batch", "2", "--reps", "2",
                                   "--scopes", "backbone,neck;backbone,neck,head_stacks,heads"])
    out = capsys.readouterr().out.splitlines()
    assert [r["scope"] for r in rows] == ["float", "backbone,neck",
                                          "backbone,neck,head_stacks,heads"]
    assert out[0].startswith("float: ") and len(out) == 3
    assert out[1].startswith("int8 [backbone,neck]: ") and "x float" in out[1]
    assert all(r["chips_per_s"] > 0 and np.isfinite(r["spread"]) for r in rows)
    assert "host clock, CPU" in out[2]
    assert len(quant_scope_bench.DEFAULT_SCOPES) == 5
