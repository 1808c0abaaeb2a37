"""The training slice as a whole against the JAX package.

Two steps of JAX ``make_train_step`` (R-18, 128^2, batch 2, float32, the
optax chain with warmup, EMA) against two steps of the port's
``train_step`` from the same weights (``state_dict_from_jax``) and the same
batches: loss items at rtol 1e-4; every parameter, BN running statistic and
EMA value after each step at atol 1e-5 + rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
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
from s2anet_tpu_torch.train.optim import Optimizer
from s2anet_tpu_torch.train.schedule import build_lr_schedule
from s2anet_tpu_torch.train.state import ModelEMA
from s2anet_tpu_torch.train.step import to_device, train_step

IMG, B, CLAMP = 128, 2, 6.0
SCHEDULE = dict(lr0=0.005, total_steps=1000, steps_per_epoch=100, warmup_iters=500)


def _close_trees(got, want, what):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(np.asarray(flat[path]), np.asarray(w),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{what} {path}")


def test_two_train_steps_match_jax():
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15,
                       align_offset_clamp=CLAMP)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32)))
    tx = jax_optimizer(jax_schedule(**SCHEDULE), params_example=variables["params"],
                       grad_clip_norm=35.0)
    state = create_train_state(variables["params"], variables["batch_stats"], tx)
    jstep = make_train_step(
        jmodel, tx, imgs_size=(IMG, IMG), num_classes=15,
        model_cfg=JaxModelConfig(backbone="resnet18", align_offset_clamp=CLAMP),
        compute_dtype=jnp.float32, donate=False)

    cfg = ModelConfig(backbone="resnet18", align_offset_clamp=CLAMP)
    model = S2ANet("resnet18", 15, align_offset_clamp=CLAMP)
    model.load_state_dict(state_dict_from_jax(variables, "resnet18"))
    model.channels_last().train()
    optimizer = Optimizer(model, build_lr_schedule(**SCHEDULE))
    ema = ModelEMA(model)

    for batch in synthetic_batches(2, B, IMG, seed=3):
        state, want = jstep(state, jax.tree_util.tree_map(jnp.asarray, batch))
        got = train_step(model, optimizer, ema, to_device(batch, "cpu", torch.float32),
                         cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
        now = convert_reference_s2anet(model.state_dict(), "resnet18")
        _close_trees(now["params"], state.params, "params")
        _close_trees(now["batch_stats"], state.batch_stats, "batch_stats")
        avg = convert_reference_s2anet(ema.module.state_dict(), "resnet18")
        _close_trees(avg["params"], state.ema_params, "ema params")
        _close_trees(avg["batch_stats"], state.ema_batch_stats, "ema batch_stats")
    assert optimizer.count == int(state.step) == 2
