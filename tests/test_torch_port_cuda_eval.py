"""Card-only tests of the evaluation runner's CUDA pipeline: the pinned
input ring (slots reused across batches, a side-stream copy), the pinned
output buffers read after their batch's event, and the wrap padding of a
partial last batch give the detections of the plain synchronous call;
so does ``predict.serve_chips``, which runs through the same pipeline.

They need an NVIDIA GPU; here they skip. On the card:

    python -m pytest tests/test_torch_port_cuda_eval.py -m cuda -q --noconftest
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig
from s2anet_tpu_torch.data.dota import DotaDataset
from s2anet_tpu_torch.eval import runner
from s2anet_tpu_torch.predict import S2ANetPredictor, serve_chips

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (its PNG writer and drawn objects)

pytestmark = pytest.mark.cuda
SIZE = 256


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = tmp_path_factory.mktemp("cuda_eval")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    for i in range(11):
        img = rng.integers(0, 90, (SIZE, SIZE, 3), dtype=np.uint8)
        chip_smoke.draw_objects(rng, img, 4, margin=60)
        png = root / "images" / f"c{i:02d}.png"
        chip_smoke.write_png(png, img)
        np.save(png.with_suffix(".npy"), img[:, :, ::-1])
    return root / "images"


@pytest.mark.parametrize("bs", [1, 4])
def test_cuda_pipeline_equals_plain_calls(chips, bs):
    """11 chips: 11 batches of 1 (every ring slot reused) or 3 of 4 (the
    last padded by wrapping); the same detections, bit for bit, as calling
    the predictor on each batch and reading its outputs at once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    model = ModelConfig(backbone="resnet18", score_thr=0.005)
    pred = S2ANetPredictor(model, device="cuda", dtype=torch.float32, seed=1)
    cfg = Config(model=model, data=DataConfig(img_size=SIZE), eval=EvalConfig(batch_size=bs))
    ds = DotaDataset(chips, img_size=SIZE)
    calls = []

    def plain(imgs):
        calls.append(len(imgs))
        return tuple(t.cpu() for t in pred.predict(imgs))

    got = runner.evaluate_on_chips(pred, cfg, dataset=ds)
    want = runner.evaluate_on_chips(plain, cfg, dataset=ds)
    assert calls == [bs] * (-(-11 // bs))
    assert got["n_images"] == want["n_images"] == 11
    assert got["chip_dets"].keys() == want["chip_dets"].keys()
    n = 0
    for chip, dets in want["chip_dets"].items():
        assert len(got["chip_dets"][chip]) == len(dets), chip
        for (c1, s1, p1), (c2, s2, p2) in zip(got["chip_dets"][chip], dets):
            assert (c1, s1) == (c2, s2)
            np.testing.assert_array_equal(p1, p2)
        n += len(dets)
    assert n > 100
    assert got["map50"] == want["map50"]


def test_cuda_scene_serving_equals_plain_calls(chips):
    """A scene of 2 x 3 windows (the last batch of 4 padded with zeros)
    through ``serve_chips`` on the card: the same merged detections, bit
    for bit, as calling the predictor on each batch and reading its outputs
    at once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    pred = S2ANetPredictor(ModelConfig(backbone="resnet18", score_thr=0.005),
                           device="cuda", dtype=torch.float32, seed=1)
    scene = np.random.default_rng(2).integers(0, 90, (400, 600, 3), dtype=np.uint8)
    chip_smoke.draw_objects(np.random.default_rng(3), scene, 12, margin=60)
    calls = []

    def plain(imgs):
        calls.append(len(imgs))
        return tuple(t.cpu() for t in pred.predict(imgs))

    got, want = (list(serve_chips(step, [("scene", scene)], SIZE, 56, 4, 0.5))
                 for step in (pred, plain))
    assert calls == [4, 4]
    assert [(n, w) for n, w, _ in got] == [(n, w) for n, w, _ in want] == [("scene", 6)]
    (_, _, dk), (_, _, dp) = got[0], want[0]
    assert len(dk) == len(dp) > 50
    for (c1, s1, p1), (c2, s2, p2) in zip(dk, dp):
        assert (c1, s1) == (c2, s2)
        np.testing.assert_array_equal(p1, p2)
