"""The training slice as a whole: the JAX ``Trainer`` against the port's
``Trainer`` from the same initial weights (the JAX init converted with
``state_dict_from_jax``).

R-18, 128^2, batch 2, 4 PNG chips (the port's synthetic writer: PNG and
BGR sidecar), one epoch in float32 with augmentation on (fliplr, flipud,
the 90-degree rotations, HSV), then validation of the EMA weights with
losses on 3 chips (a partial batch, padded by wrapping). Bars: the same
``results.csv`` columns; the train loss items within rtol 1e-4; the final
parameters, BN statistics and EMA within rtol 1e-4 / atol 1e-5; the val
losses within 1e-3 and mAP50 within 0.01; the same update count and
learning rate.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from s2anet_tpu.models.torch_import import convert_reference_s2anet
from s2anet_tpu.train.trainer import Trainer as JaxTrainer
from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import config
from s2anet_tpu_torch.data import synth
from s2anet_tpu_torch.models.convert import state_dict_from_jax
from s2anet_tpu_torch.train.trainer import Trainer

SIZE = 128


def _overrides(root, save_dir):
    return {
        "model": {"backbone": "resnet18", "num_classes": 3, "max_per_img": 50,
                  "pre_nms_cap": 256, "max_before_nms_per_level": 100,
                  "align_offset_clamp": 6.0},
        "data": {"root": str(root / "train/images"), "train_list": str(root / "train/images"),
                 "val_list": str(root / "val/images"), "img_size": SIZE, "max_gt": 8,
                 "names": ["a", "b", "c"], "flipud": 0.5, "hsv_h": 0.015, "hsv_s": 0.5,
                 "hsv_v": 0.3, "workers": 2},
        "train": {"epochs": 1, "batch_size": 2, "dtype": "float32", "warmup_iters": 4,
                  "ema_ramp_updates": 2, "save_dir": str(save_dir), "plots": False,
                  "seed": 3},
        "eval": {"batch_size": 2, "use_07_metric": False},
    }


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _close_trees(got, want, what):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(np.asarray(flat[path]), np.asarray(w),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{what} {path}")


def test_trainer_matches_jax(tmp_path):
    root = tmp_path / "data"
    rng = np.random.default_rng(1)
    synth.write_split(root / "train", 4, rng, SIZE, 3, 3)
    synth.write_split(root / "val", 3, rng, SIZE, 3, 3)  # a partial last batch

    jcfg = jax_config.load_config(None, _overrides(root, tmp_path / "jax"))
    jt = JaxTrainer(jcfg)
    variables = jax.device_get(jt.model.init(
        jax.random.PRNGKey(jcfg.train.seed), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32),
        train=False))
    state = jax.device_get(jt.train())

    cfg = config.load_config(None, _overrides(root, tmp_path / "port"))
    assert (dataclasses.replace(cfg.train, save_dir="") ==
            config.TrainConfig(**dataclasses.asdict(dataclasses.replace(jcfg.train,
                                                                          save_dir=""))))
    pt = Trainer(cfg, device="cpu")
    pt.train(weights=state_dict_from_jax(variables, "resnet18"))

    want, got = _csv(tmp_path / "jax/results.csv"), _csv(tmp_path / "port/results.csv")
    assert list(got[0]) == list(want[0]) and len(got) == len(want) == 1
    g, w = got[0], want[0]
    for k in g:
        if k.startswith("train/") or k == "lr/0":
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-4, err_msg=k)
        elif k.startswith("val/"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), atol=1e-3, err_msg=k)
        elif k in ("metrics/mAP_0.5", "map50"):
            assert abs(float(g[k]) - float(w[k])) <= 0.01, k
    assert pt.optimizer.micro == pt.optimizer.count == int(state.step) == 2

    now = convert_reference_s2anet(pt.model.state_dict(), "resnet18")
    _close_trees(now["params"], state.params, "params")
    _close_trees(now["batch_stats"], state.batch_stats, "batch_stats")
    avg = convert_reference_s2anet(pt.ema.module.state_dict(), "resnet18")
    _close_trees(avg["params"], state.ema_params, "ema params")
    _close_trees(avg["batch_stats"], state.ema_batch_stats, "ema batch_stats")
    for name in ("last", "best", "deploy"):
        assert (tmp_path / "port/weights" / name).exists()
        assert (tmp_path / "jax/weights" / name).exists()
