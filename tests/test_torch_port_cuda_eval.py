"""Card-only tests of the evaluation runner's CUDA pipeline: the pinned
input ring (slots reused across batches, a side-stream copy), the pinned
output buffers read after their batch's event, and the wrap padding of a
partial last batch give the detections of the plain synchronous call;
so does ``predict.serve_chips``, which runs through the same pipeline.
Rect batches (a shape per batch, staged from slots sized for the largest):
each staged batch equals the loader's host batch, and the detections equal
the plain calls'; the AlignConv forward on their non-square maps, whose
cell counts are not multiples of the kernel's 128-cell tile, equals its
plain version.

They need an NVIDIA GPU; here they skip. On the card:

    python -m pytest tests/test_torch_port_cuda_eval.py -m cuda -q --noconftest
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig
from s2anet_tpu_torch.data.dota import BatchLoader, DotaDataset
from s2anet_tpu_torch.data.synth import write_png
from s2anet_tpu_torch.eval import runner
from s2anet_tpu_torch.ops import deform_conv as dc
from s2anet_tpu_torch.predict import S2ANetPredictor, serve_chips

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (its drawn objects)

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
        write_png(png, img)
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


RECT_HW = [(96, 256), (256, 160), (128, 256), (200, 256), (256, 256), (100, 240), (256, 120)]


@pytest.fixture(scope="module")
def rect_chips(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = tmp_path_factory.mktemp("cuda_rect")
    rng = np.random.default_rng(4)
    (root / "images").mkdir()
    for i, (h, w) in enumerate(RECT_HW):
        img = rng.integers(0, 90, (h, w, 3), dtype=np.uint8)
        chip_smoke.draw_objects(rng, img, 3, margin=30)
        png = root / "images" / f"r{i:02d}.png"
        write_png(png, img)
        np.save(png.with_suffix(".npy"), img[:, :, ::-1])
    return root / "images"


def _rect_cfg(model, bs):
    return Config(model=model, data=DataConfig(img_size=SIZE),
                  eval=EvalConfig(batch_size=bs, rect=True))


@pytest.mark.parametrize("bs", [2, 3])
def test_cuda_rect_pipeline_stages_the_host_batch(rect_chips, bs):
    """Each rect batch staged on the card equals the loader's host batch
    (the short last one wrap-padded), whatever slot and shape came
    before it."""
    k = 4

    class Recorder:
        device = torch.device("cuda", 0)

        def __init__(self):
            self.seen = []

        def predict(self, x):
            assert x.is_cuda and x.is_contiguous()
            self.seen.append(x.cpu().numpy())
            b = x.shape[0]
            return (torch.zeros(b, k, 6, device=x.device),
                    torch.zeros(b, k, dtype=torch.int64, device=x.device),
                    torch.zeros(b, k, dtype=torch.bool, device=x.device))

    ds = DotaDataset(rect_chips, img_size=SIZE)
    want = []
    for batch in BatchLoader(ds, bs, rect=True):
        imgs = batch["imgs"]
        want.append(imgs[np.arange(bs) % len(imgs)])
    rec = Recorder()
    out = runner.evaluate_on_chips(rec, _rect_cfg(ModelConfig(backbone="resnet18"), bs),
                                   dataset=ds)
    assert out["n_images"] == len(RECT_HW) and len(rec.seen) == len(want)
    assert len({w.shape for w in want}) > 1
    for got, w in zip(rec.seen, want):
        assert got.shape == w.shape
        np.testing.assert_array_equal(got, w)


def test_cuda_rect_pipeline_equals_plain_calls(rect_chips):
    """Rect evaluation through the pinned ring gives the detections of the
    plain synchronous calls, bit for bit, at every batch shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    model = ModelConfig(backbone="resnet18", score_thr=0.005)
    pred = S2ANetPredictor(model, device="cuda", dtype=torch.float32, seed=1)
    ds = DotaDataset(rect_chips, img_size=SIZE)
    shapes = []

    def plain(imgs):
        shapes.append(imgs.shape[1:3])
        return tuple(t.cpu() for t in pred.predict(imgs))

    got = runner.evaluate_on_chips(pred, _rect_cfg(model, 2), dataset=ds)
    want = runner.evaluate_on_chips(plain, _rect_cfg(model, 2), dataset=ds)
    assert len(set(shapes)) > 1 and got["n_images"] == want["n_images"] == len(RECT_HW)
    n = 0
    for chip, dets in want["chip_dets"].items():
        assert len(got["chip_dets"][chip]) == len(dets), chip
        for (c1, s1, p1), (c2, s2, p2) in zip(got["chip_dets"][chip], dets):
            assert (c1, s1) == (c2, s2)
            np.testing.assert_array_equal(p1, p2)
        n += len(dets)
    assert n > 100 and got["map50"] == want["map50"]


# the five levels of a rect batch of 2 at 544 x 832 (HRSC at 800, stride
# 32), and of 1 at 1056 x 544 (DOTA at 1024): B * H * W never a multiple of 128
RECT_LEVELS = [(2, 68, 104), (2, 34, 52), (2, 17, 26), (2, 9, 13), (2, 5, 7),
               (1, 132, 68), (1, 17, 9), (1, 9, 5), (1, 5, 3)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,w", RECT_LEVELS, ids=lambda v: str(v))
def test_deform_fwd_on_rect_maps(b, h, w, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    assert (b * h * w) % 128 and h != w
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(h * 1000 + w)
    x = torch.randn(b, h, w, 256, generator=gen, device=dev).to(dtype)
    off = torch.randn(b, h, w, 9, 2, generator=gen, device=dev) * 3.0
    off[:, :, -1, :3, 1] += 40.0  # the last column samples past the right edge
    wt = (torch.randn(3, 3, 256, 256, generator=gen, device=dev) * 0.05).to(dtype)
    before = dc.DEFORM_FWD.launches
    got = dc.deform_conv2d(x, off.to(dtype), wt)
    torch.cuda.synchronize()
    assert dc.DEFORM_FWD.launches == before + 1
    ref = dc.deform_conv2d_plain(x, off.to(dtype), wt)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("valid", ["all", "scattered", "none"])
def test_single_class_nms_on_the_card(valid):
    """``nms_rotated`` / ``ml_nms_rotated`` on CUDA tensors launch the mask
    and the sweep once each and keep what the plain keep keeps."""
    from unittest import mock

    from s2anet_tpu_torch.ops import nms_rotated as nms

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    boxes, labels, _ = (t[0] for t in chip_smoke.clustered_candidates(torch, gen, 1, 1500, dev))
    scores = torch.randint(0, 10, (1500,), generator=gen, device=dev).float() / 10
    v = {"all": None, "none": torch.zeros(1500, dtype=torch.bool, device=dev),
         "scattered": torch.rand(1500, generator=gen, device=dev) < 0.6}[valid]
    for fn in (lambda: nms.nms_rotated(boxes, scores, 0.5, v),
               lambda: nms.ml_nms_rotated(boxes, scores, labels, 0.5, v)):
        before = (nms.NMS_MASK.launches, nms.NMS_SWEEP.launches)
        keep = fn()
        assert (nms.NMS_MASK.launches - before[0], nms.NMS_SWEEP.launches - before[1]) == (1, 1)
        with mock.patch.object(nms, "nms_keep", nms.nms_keep_plain):
            want = fn()
        assert keep.is_cuda and torch.equal(keep, want)
        assert (int(keep.sum()) > 0) == (valid != "none")
