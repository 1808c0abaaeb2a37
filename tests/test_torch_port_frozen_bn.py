"""Frozen stages against the JAX package: the BatchNorms of frozen stages
run in inference mode while the model trains.

R-18, 2 images of 64^2, seeded, float32, on the CPU, with random running
statistics (so that inference and training BatchNorm differ). For
``frozen_stages`` -1 (nothing frozen), 0 (the stem), 1 (the stem and
layer1) and 4 (the whole backbone):

* one train-mode forward of the port and of the JAX detector on the same
  weights and images: every head output within 1e-4, and the running
  statistics after it within 1e-5 of JAX's, those of the frozen stages
  unchanged in both;
* one train step of each (forward, loss, backward, optimizer with the
  frozen stages masked, EMA): the four loss items within 1e-4, and the
  parameters and running statistics after it as
  tests/test_torch_port_train_step.py holds them (rtol 1e-4, atol 1e-5).

Before the port applied the JAX ``bn_train(stage)`` rule, a frozen stage's
BatchNorm normalised with batch statistics and overwrote its running
statistics every step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.torch_import import convert_reference_s2anet
from s2anet_tpu.parallel.step import make_train_step
from s2anet_tpu.train.optim import build_optimizer as jax_optimizer
from s2anet_tpu.train.schedule import build_lr_schedule as jax_schedule
from s2anet_tpu.train.state import create_train_state
from s2anet_tpu.utils.config import ModelConfig as JaxModelConfig
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.models.convert import state_dict_from_jax
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.train.__main__ import synthetic_batches
from s2anet_tpu_torch.train.optim import Optimizer, freeze_stages
from s2anet_tpu_torch.train.schedule import build_lr_schedule
from s2anet_tpu_torch.train.state import ModelEMA
from s2anet_tpu_torch.train.step import to_device, train_step

ARCH, IMG, B = "resnet18", 64, 2
SCHEDULE = dict(lr0=0.005, total_steps=1000, steps_per_epoch=100, warmup_iters=500)
OUT_KEYS = ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox")


def jax_variables(model_kw, seed=0):
    """Seeded JAX variables with random running statistics."""
    jmodel = JaxS2ANet(backbone_name=ARCH, num_classes=15, **model_kw)
    v = jax.device_get(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 3), jnp.float32)))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.2, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
        v["batch_stats"])
    return jmodel, {"params": v["params"], "batch_stats": stats}


def port_model(model_kw, variables):
    model = S2ANet.from_config(ModelConfig(backbone=ARCH, **model_kw))
    model.load_state_dict(state_dict_from_jax(variables, ARCH))
    return model.channels_last().train()


def jax_tree(model):
    """The port's weights as the JAX tree. The JAX bridge files a plain
    ``or_conv``'s bias under ``or_bias``; a head without the ORConv keeps
    it in ``or_conv``."""
    tree = convert_reference_s2anet(model.state_dict(), ARCH)
    head = tree["params"]["head"]
    if "or_conv" in head:
        head["or_conv"]["bias"] = head.pop("or_bias")
    return tree


def close_trees(got, want, what, rtol=1e-4, atol=1e-5):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(np.asarray(flat[path]), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {path}")


def frozen_bn_paths(frozen_stages, norm_eval=False):
    """Paths (JAX tree keys) of the backbone's BatchNorms that do not train."""
    def stage(key):
        return 0 if key == "bn1" else int(key[len("layer")])
    return lambda path: (path[0].key == "backbone"
                         and (norm_eval or stage(path[1].key) <= frozen_stages))


def check_forward(model_kw, frozen):
    """One train-mode forward of both models; ``frozen(path)`` says which
    running statistics must stay."""
    jmodel, variables = jax_variables(model_kw)
    imgs = np.random.default_rng(5).uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    want, upd = jax.jit(lambda v, x: jmodel.apply(v, x, train=True,
                                                  mutable=["batch_stats"]))(
        variables, jnp.asarray(imgs))
    model = port_model(model_kw, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    for key in OUT_KEYS:
        for lvl, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key}[{lvl}]")
    now = jax_tree(model)["batch_stats"]
    close_trees(now, upd["batch_stats"], "running statistics", rtol=1e-5, atol=1e-5)
    n_frozen = 0
    for path, before in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        after_port = dict(jax.tree_util.tree_leaves_with_path(now))[path]
        after_jax = dict(jax.tree_util.tree_leaves_with_path(upd["batch_stats"]))[path]
        if frozen(path):
            n_frozen += 1
            np.testing.assert_array_equal(after_port, before, err_msg=str(path))
            np.testing.assert_array_equal(after_jax, before, err_msg=str(path))
        else:
            assert not np.array_equal(after_port, before), path
    return n_frozen


def check_train_step(model_kw, frozen_stages=-1):
    """One train step of both; returns the port model after it."""
    jmodel, variables = jax_variables(model_kw)
    tx = jax_optimizer(jax_schedule(**SCHEDULE), params_example=variables["params"],
                       grad_clip_norm=35.0, frozen_stages=frozen_stages)
    state = create_train_state(variables["params"], variables["batch_stats"], tx)
    jcfg = dataclasses.replace(JaxModelConfig(backbone=ARCH), **model_kw)
    jstep = make_train_step(jmodel, tx, imgs_size=(IMG, IMG), num_classes=15,
                            model_cfg=jcfg, compute_dtype=jnp.float32, donate=False)
    model = port_model(model_kw, variables)
    freeze_stages(model, frozen_stages)
    optimizer = Optimizer(model, build_lr_schedule(**SCHEDULE))
    ema = ModelEMA(model)
    batch = synthetic_batches(1, B, IMG, seed=3)[0]
    state, want = jstep(state, jax.tree_util.tree_map(jnp.asarray, batch))
    got = train_step(model, optimizer, ema, to_device(batch, "cpu", torch.float32),
                     ModelConfig(backbone=ARCH, **model_kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    now = jax_tree(model)
    close_trees(now["params"], state.params, "params")
    close_trees(now["batch_stats"], state.batch_stats, "batch_stats")
    return model


@pytest.mark.parametrize("frozen_stages,n_frozen", [(-1, 0), (0, 2), (1, 10), (4, 40)])
def test_frozen_stages_forward_match_jax(frozen_stages, n_frozen):
    """(R-18: the stem's BatchNorm, 4 in layer1 and 5 in each later stage;
    2 statistics each.)"""
    kw = {"frozen_stages": frozen_stages}
    assert check_forward(kw, frozen_bn_paths(frozen_stages)) == n_frozen


@pytest.mark.parametrize("frozen_stages", [-1, 0, 1, 4])
def test_frozen_stages_train_step_match_jax(frozen_stages):
    model = check_train_step({"frozen_stages": frozen_stages}, frozen_stages)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    frozen = {1: 5, 4: 20, 0: 1, -1: 0}[frozen_stages]
    assert sum(not m.training for m in bns) == frozen
    # train() and the EMA's eval() copy keep the rule
    model.eval().train()
    assert sum(not m.training for m in bns) == frozen
    assert all(not m.weight.requires_grad for m in bns if not m.training)
