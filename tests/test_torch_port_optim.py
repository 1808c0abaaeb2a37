"""The port's optimizer and EMA against the JAX chain.

The same gradient trees (seeded normal, large enough that the clip at 35
acts) go, over 4 micro-steps, through the JAX ``build_optimizer`` (clip,
masked decay, SGD with momentum; ``optax.multi_transform`` for frozen
stages; ``optax.MultiSteps`` for accumulation) and through the port's
``Optimizer`` (``freeze_stages`` and ``accumulate``), for frozen_stages in
{-1, 1, 4} x accumulate in {1, 2}, R-18: every parameter equal within
rtol 1e-6 after each micro-step, frozen ones unchanged, the update counts
equal, and the EMA equal to ``ema_update``'s rule (blend on the sync
micro-steps, decay ramp over updates) within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.torch_import import convert_reference_s2anet
from s2anet_tpu.train.optim import build_optimizer, freeze_mask
from s2anet_tpu.train.schedule import build_lr_schedule as jax_schedule
from s2anet_tpu.train.state import create_train_state, ema_update
from s2anet_tpu_torch.models.convert import state_dict_from_jax
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.train.optim import Optimizer, freeze_stages, is_frozen
from s2anet_tpu_torch.train.schedule import build_lr_schedule
from s2anet_tpu_torch.train.state import ModelEMA

SCHEDULE = dict(lr0=0.01, total_steps=40, steps_per_epoch=10, warmup_iters=3)
DECAY, RAMP = 0.9999, 3


@pytest.fixture(scope="module")
def variables():
    m = JaxS2ANet(backbone_name="resnet18", num_classes=3)
    return jax.device_get(jax.jit(lambda k, x: m.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


def _close(got, want, what):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(np.asarray(flat[path]), np.asarray(w), rtol=1e-6,
                                   atol=1e-9, err_msg=f"{what} {path}")


def test_freeze_rule_matches_jax(variables):
    sd = state_dict_from_jax(variables, "resnet18")
    for fs in (-1, 0, 1, 2, 4):
        mask = freeze_mask(variables["params"], fs)
        flat = {jax.tree_util.keystr(p): t for p, t in jax.tree_util.tree_leaves_with_path(mask)}
        n_frozen_jax = sum(not t for t in flat.values())
        n_frozen = sum(is_frozen(k, fs) for k in sd if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked")))
        assert n_frozen == n_frozen_jax, fs


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("frozen_stages", [-1, 1, 4])
def test_optimizer_and_ema_match_jax(variables, frozen_stages, accumulate):
    params, stats = variables["params"], variables["batch_stats"]
    tx = build_optimizer(jax_schedule(**SCHEDULE), params_example=params,
                         frozen_stages=frozen_stages, accumulate=accumulate)
    state = create_train_state(params, stats, tx)

    @jax.jit
    def jstep(state, g):
        updates, opt_state = tx.update(g, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        state = state.replace(step=state.step + 1, params=new_params, opt_state=opt_state)
        return ema_update(state, new_params, state.batch_stats, DECAY, RAMP,
                          accumulate=accumulate)

    model = S2ANet("resnet18", 3)
    model.load_state_dict(state_dict_from_jax(variables, "resnet18"))
    n_frozen = freeze_stages(model, frozen_stages)
    assert (n_frozen > 0) == (frozen_stages >= 0)
    opt = Optimizer(model, build_lr_schedule(**SCHEDULE), accumulate=accumulate)
    ema = ModelEMA(model, DECAY, RAMP)
    named = dict(model.named_parameters())

    for micro in range(4):
        g = _grads(params, micro)
        state = jax.device_get(jstep(state, g))

        gsd = state_dict_from_jax({"params": g, "batch_stats": stats}, "resnet18")
        for k, p in named.items():
            p.grad = gsd[k].clone() if p.requires_grad else None
        opt.step()
        if opt.synced:
            ema.update(model, opt.count)

        now = convert_reference_s2anet(model.state_dict(), "resnet18")
        _close(now["params"], state.params, f"micro-step {micro} params")
        avg = convert_reference_s2anet(ema.module.state_dict(), "resnet18")
        _close(avg["params"], state.ema_params, f"micro-step {micro} ema")
    assert opt.micro == int(state.step) == 4
    assert opt.count == 4 // accumulate
    frozen = [p for p in model.parameters() if not p.requires_grad]
    assert len(frozen) == n_frozen
