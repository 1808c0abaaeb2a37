"""The spans at the port's layer boundaries (``utils/profiler.py::span``),
on the CPU at R-18 64^2.

* Under ``torch.profiler``, ``S2ANetPredictor.predict``, ``to_device`` and
  ``train_step`` record their spans, nested as the layers nest; read from
  the exported Chrome trace.
* ``BatchPipeline.run`` records its waits and its ``seconds`` dict reads
  as before; ``stage`` records its span.
* With no profiler recording, neither call enters a profiler range.
* ``export_serving`` under a recording profiler gives a program with no
  profiler node.
"""

import numpy as np
import pytest
import torch

from s2anet_tpu_torch import export
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.eval.runner import BatchPipeline
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.predict import S2ANetPredictor
from s2anet_tpu_torch.tools import profile_report as pr
from s2anet_tpu_torch.train.__main__ import synthetic_batches
from s2anet_tpu_torch.train.optim import Optimizer
from s2anet_tpu_torch.train.schedule import build_lr_schedule
from s2anet_tpu_torch.train.state import ModelEMA
from s2anet_tpu_torch.train.step import to_device, train_step
from s2anet_tpu_torch.utils import profiler

SIZE, BATCH, NC = 64, 2, 2
CFG = ModelConfig(backbone="resnet18", num_classes=NC, score_thr=0.005, max_per_img=50,
                  pre_nms_cap=128, max_before_nms_per_level=50)

PREDICT = {"s2anet.predict": None, "s2anet.forward": "s2anet.predict",
           "s2anet.backbone": "s2anet.forward", "s2anet.neck": "s2anet.forward",
           "s2anet.head": "s2anet.forward", "s2anet.post": "s2anet.predict",
           "s2anet.decode": "s2anet.post", "s2anet.nms": "s2anet.post"}
TRAIN = {"s2anet.train.feed": None, "s2anet.train.step": None,
         "s2anet.forward": "s2anet.train.step", "s2anet.backbone": "s2anet.forward",
         "s2anet.train.loss": "s2anet.train.step", "s2anet.train.assign": "s2anet.train.loss",
         "s2anet.train.backward": "s2anet.train.step",
         "s2anet.train.update": "s2anet.train.step", "s2anet.train.ema": "s2anet.train.update"}


@pytest.fixture(scope="module")
def predictor():
    pred = S2ANetPredictor(CFG, device="cpu", dtype=torch.float32, seed=0)
    imgs = np.random.default_rng(0).integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    return pred, imgs


@pytest.fixture(scope="module")
def trainer():
    model = S2ANet.from_config(CFG).init_weights(torch.Generator().manual_seed(0))
    model = model.channels_last().train()
    optimizer = Optimizer(model, build_lr_schedule(0.005, 100, 10))
    ema = ModelEMA(model)
    (batch,) = synthetic_batches(1, BATCH, SIZE, seed=3)
    return model, optimizer, ema, batch


def _train(trainer):
    model, optimizer, ema, batch = trainer
    return train_step(model, optimizer, ema, to_device(batch, "cpu", torch.float32), CFG)


def _spans(tmp_path, fn):
    """The ``s2anet.*`` ranges that ``fn()`` records under the profiler,
    read from the written Chrome trace: ``[(name, start, end)]``."""
    with profiler.trace(tmp_path):
        fn()
    (path,) = tmp_path.glob("trace_*.pt.trace.json")
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in pr.load_events(path)
            if e.get("ph") == "X" and str(e.get("name", "")).startswith("s2anet.")]


def _check_nesting(found, parents):
    """Each span of ``parents`` is recorded, and each lies inside a span of
    its parent."""
    assert set(parents) <= {name for name, _, _ in found}, found
    for name, t0, t1 in found:
        parent = parents.get(name)
        if parent is not None:
            assert any(p == parent and p0 <= t0 and t1 <= p1 for p, p0, p1 in found), name


def test_predict_records_its_spans_nested(predictor, tmp_path):
    pred, imgs = predictor
    found = _spans(tmp_path, lambda: pred.predict(imgs))
    _check_nesting(found, PREDICT)
    assert [n for n, _, _ in found].count("s2anet.predict") == 1


def test_train_step_records_its_spans_nested(trainer, tmp_path):
    found = _spans(tmp_path, lambda: _train(trainer))
    _check_nesting(found, TRAIN)
    (feed,) = [(t0, t1) for n, t0, t1 in found if n == "s2anet.train.feed"]
    (step,) = [(t0, t1) for n, t0, t1 in found if n == "s2anet.train.step"]
    assert feed[1] <= step[0]  # the feed comes before the step, outside it


def test_pipeline_records_its_waits_and_keeps_its_seconds(tmp_path):
    calls = []

    def step(x):
        calls.append(x.copy())
        return (torch.ones(BATCH, 3, 6), torch.zeros(BATCH, 3), torch.ones(BATCH, 3, dtype=bool))

    def run():
        with BatchPipeline(step, BATCH, 8, n=3) as pipe:
            def batches():
                for i in range(4):
                    pipe.slot(i)[:] = i
                    yield BATCH - i % 2, i
            outs = list(pipe.run(batches(), seconds))
            staged = pipe.stage(4)
        return outs, staged

    seconds = {"loader_wait": 0.0, "device_wait": 0.0}
    found = _spans(tmp_path, run)
    names = [n for n, _, _ in found]
    # one wait for each batch and one for the end; the CPU path fetches each
    # batch, and stages only when asked
    assert names.count("s2anet.pipeline.wait_loader") == 5
    assert names.count("s2anet.pipeline.wait_device") == 4
    assert names.count("s2anet.pipeline.stage") == 1
    assert "s2anet.pipeline.copy_out" not in names  # the CUDA path's only
    assert set(seconds) == {"loader_wait", "device_wait"}
    assert all(v > 0 for v in seconds.values())
    # the same waits recorded on the host clock with no profiler
    seconds = {"loader_wait": 0.0, "device_wait": 0.0}
    calls.clear()
    outs, staged = run()
    assert [m for _, _, m in outs] == [0, 1, 2, 3] and [b for _, b, _ in outs] == [2, 1, 2, 1]
    assert [int(c[0, 0, 0, 0]) for c in calls] == [0, 1, 2, 3]
    assert all(o[0].shape[0] == b for o, b, _ in outs) and staged.shape == (BATCH, 8, 8, 3)
    assert all(v > 0 for v in seconds.values())


def test_span_adds_seconds_recorded_or_not():
    seconds = {"wait": 1.0}
    with profiler.span("s2anet.x", seconds, "wait"):
        pass
    after = seconds["wait"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("s2anet.x", seconds, "wait"):
            pass
    assert 1.0 < after < seconds["wait"]


def test_no_range_is_entered_with_no_profiler(predictor, trainer, monkeypatch):
    pred, imgs = predictor
    entered = []
    real = profiler.record_function

    def counted(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(profiler, "record_function", counted)
    pred.predict(imgs)
    _train(trainer)
    assert entered == []
    # the same calls under a profiler enter every span once
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pred.predict(imgs)
        _train(trainer)
    assert sorted(set(entered)) == sorted(set(PREDICT) | set(TRAIN))
    assert entered.count("s2anet.predict") == 1 and entered.count("s2anet.train.step") == 1


def test_export_under_a_profiler_holds_no_profiler_node(predictor):
    pred, _ = predictor
    module = export.serving_module(pred)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program = export.export_serving(module, 1, SIZE, "cpu")
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert any(t.startswith("s2anet.") for t in targets)  # the serving ops are there
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
