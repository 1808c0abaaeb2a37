"""The port's serving entry point on the CPU, at a tiny size: the CLI's
output format, weight loading from a ``.pt`` state_dict and from an ``.npz``
of JAX variables, and no silent CPU run when CUDA was asked for."""

import json

import numpy as np
import pytest
import torch

from s2anet_tpu.models.torch_import import convert_reference_s2anet
from s2anet_tpu_torch import predict
from s2anet_tpu_torch.config import DOTA10_CLASSES, ModelConfig
from s2anet_tpu_torch.models.convert import save_jax_npz
from s2anet_tpu_torch.models.detector import S2ANet

R18 = ModelConfig(backbone="resnet18")


def test_cli_writes_dota_lines(tmp_path, capsys):
    summary = predict.main([
        "--synthetic", "3", "--batch-size", "2", "--img-size", "64",
        "--backbone", "resnet18", "--device", "cpu", "--dtype", "float32",
        "--conf", "0.005", "--save-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == summary
    assert summary["chips"] == 3 and summary["detections"] > 0
    assert [line.split(":")[0] for line in out[:-1]] == [
        f"synthetic_{i:04d}" for i in range(3)]
    n = 0
    for i in range(3):
        for line in (tmp_path / f"synthetic_{i:04d}.txt").read_text().splitlines():
            name, score, *coords = line.split()
            assert name in DOTA10_CLASSES and 0.005 < float(score) <= 1.0
            assert len(coords) == 8 and all(np.isfinite(float(c)) for c in coords)
            n += 1
    assert n == summary["detections"]


def test_predictor_loads_pt_and_npz(tmp_path):
    imgs = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    sd = S2ANet("resnet18").init_weights(torch.Generator().manual_seed(3)).state_dict()
    torch.save(sd, tmp_path / "w.pt")
    save_jax_npz(tmp_path / "w.npz", convert_reference_s2anet(sd, "resnet18"))
    kw = dict(device="cpu", dtype=torch.float32)
    want = predict.S2ANetPredictor(R18, seed=3, **kw).predict(imgs, score_thr=0.005)
    assert want[2].any()
    for path in ("w.pt", "w.npz"):
        got = predict.S2ANetPredictor(R18, str(tmp_path / path), **kw).predict(
            imgs, score_thr=0.005)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.S2ANetPredictor(R18, device="cuda")
