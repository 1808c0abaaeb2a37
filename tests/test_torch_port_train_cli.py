"""``python -m s2anet_tpu_torch.train`` on the CPU: a two-step run at R-18
128^2 batch 2 float32 gives finite losses and a JSON summary, its EMA
weights load into the predictor, and the host-side gt tier; without a card
``--device cuda`` raises instead of falling back."""

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.predict import S2ANetPredictor
from s2anet_tpu_torch.train.__main__ import main, synthetic_batches
from s2anet_tpu_torch.train.step import to_device

ARGS = ["--backbone", "resnet18", "--img-size", "128", "--batch-size", "2",
        "--dtype", "float32"]


def test_train_cli_cpu_and_saved_weights(tmp_path, capsys):
    path = tmp_path / "ema.pt"
    summary = main(ARGS + ["--device", "cpu", "--steps", "1", "--warmup", "1",
                           "--synthetic", "2", "--save", str(path)])
    lines = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0] for l in lines[:2]] == ["step 0", "step 1"]
    assert np.isfinite(summary["losses"]).all() and len(summary["losses"]) == 4
    assert summary["steps"] == 1 and summary["ms_per_step"] > 0
    assert summary["peak_memory_gib"] is None  # no device memory on the CPU
    assert set(summary["launches_per_step"].values()) == {0.0}
    pred = S2ANetPredictor(ModelConfig(backbone="resnet18", max_per_img=50,
                                       pre_nms_cap=256),
                           weights=str(path), device="cpu", dtype=torch.float32)
    boxes, _, _ = pred.predict(np.zeros((1, 128, 128, 3), np.uint8), score_thr=0.0)
    assert boxes.shape == (1, 50, 6) and torch.isfinite(boxes).all()


def test_train_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(ARGS + ["--device", "cuda", "--steps", "1"])


def test_to_device_gt_tier():
    """More than 64 gt slots but at most 64 real gts per image: only the
    first 64 columns go to the device (the JAX step's lax.cond tier)."""
    b = synthetic_batches(1, 2, 128, seed=0, max_gt=96)[0]
    assert to_device(b, "cpu", torch.float32)["gt_boxes"].shape == (2, 64, 5)
    b["gt_mask"][0, :70] = True
    t = to_device(b, "cpu", torch.bfloat16)
    assert t["gt_mask"].shape == (2, 96) and t["imgs"].dtype == torch.bfloat16
    assert t["imgs"].is_contiguous(memory_format=torch.channels_last)
