"""The data-parallel train step against the JAX package's mesh step.

Two steps of JAX ``make_train_step(..., mesh=make_mesh(2))`` on two of the
virtual CPU devices (R-18, 128^2, global batch 4, float32, the optax chain
with warmup, EMA) against two steps of the port's ``train_step`` on two
gloo ranks of 2 images each, from the same weights (``state_dict_from_jax``)
and the same batches. Cases: full BatchNorm statistics; ``bn_stats_images``
1 (only rank 0 has statistics rows) and 3 (the prefix spans both ranks);
and a batch whose images on rank 1 hold no gt. Bars as
``test_torch_port_train_step.py``: loss items of each step at rtol 1e-4;
every parameter, BN running statistic and EMA value after the two steps at
atol 1e-5 + rtol 1e-4; and the two ranks' states equal bit for bit. At
the warmup's learning rate those bars see a gradient error only as large
as the gradient itself, so the first step's gradient summed over the
ranks is also held against the port's one process on the global batch
(itself held against JAX by ``test_torch_port_train_step.py``), on the
ranks' assignment codes (an anchor whose IoU lies within rounding of 0.4
or 0.5 takes another code on the other path). Where the BN statistics
are summed over both ranks, their rounding differs from one process's,
and at this size (4 images of 128^2, layer 4 on 64 rows) that flips ReLUs
and max-pool picks: measured up to 1.02e-2 of a tensor's norm and 2.8e-3
of the whole, so the bars are 5e-2 a tensor and 1e-2 the whole. With
``bn_stats_images`` 1 the statistics are rank 0's alone, the same sums,
and the gradient agrees within 8.4e-7 of its norm: bars 1e-4 a tensor,
1e-5 the whole. A sum that misses a rank, or adds the BatchNorms'
already global gamma and beta gradients again, is off by half or all of
those tensors.

The ranks (spawned, ``file://`` store, join timeout: see
``test_torch_port_ddp.py``) run every case in one world, started before
the JAX steps compile; JAX is imported only in the test functions, so the
spawned ranks load torch alone.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.models import head
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.parallel import mesh
from s2anet_tpu_torch.train.__main__ import synthetic_batches
from s2anet_tpu_torch.train.optim import Optimizer
from s2anet_tpu_torch.train.schedule import build_lr_schedule
from s2anet_tpu_torch.train.state import ModelEMA
from s2anet_tpu_torch.train.step import to_device, train_step
from test_torch_port_ddp import WORLD, join_group, join_world, start_world

IMG, GLOBAL_B, CLAMP = 128, 4, 6.0
SCHEDULE = dict(lr0=0.005, total_steps=1000, steps_per_epoch=100, warmup_iters=500)
CASES = {"full": 0, "stats_images_1": 1, "stats_images_3": 3, "no_gt_on_rank_1": 0}


def _batches(case):
    batches = synthetic_batches(2, GLOBAL_B, IMG, seed=3)
    if case == "no_gt_on_rank_1":
        for b in batches:
            b["gt_mask"][GLOBAL_B // WORLD:] = False
    return batches


def _first_grads(model, optimizer) -> dict:
    """The gradients the optimizer's first update is given, by name (the
    step's ``optimizer.step`` is wrapped to take them)."""
    grads, step = {}, optimizer.step

    def logged():
        if not grads:
            grads.update((n, p.grad.clone()) for n, p in model.named_parameters()
                         if p.requires_grad)
        step()
    optimizer.step = logged
    return grads


def _assignment(log, codes=None):
    """A patch that logs each assignment's codes (FAM, then ODM) and, given
    ``codes``, returns those instead."""
    assign = head.assign_labels

    def logged(*args, **kw):
        log.append(assign(*args, **kw))
        return log[-1] if codes is None else codes[len(log) - 1]
    return mock.patch.object(head, "assign_labels", logged)


def _one_process_grads(weights, case, codes) -> dict:
    """The port's first-step gradient in one process on the global batch,
    with the assignment ``codes``."""
    cfg = ModelConfig(backbone="resnet18", align_offset_clamp=CLAMP, bn_stats_images=CASES[case])
    model = S2ANet.from_config(cfg)
    model.load_state_dict(weights)
    model.channels_last().train()
    optimizer = Optimizer(model, build_lr_schedule(**SCHEDULE))
    grads = _first_grads(model, optimizer)
    with _assignment([], codes):
        train_step(model, optimizer, ModelEMA(model),
                   to_device(_batches(case)[0], "cpu", torch.float32), cfg)
    return grads


def _step_world(rank, store, out):
    join_group(rank, store)
    b = GLOBAL_B // WORLD
    part = slice(rank * b, (rank + 1) * b)
    weights = torch.load(out / "weights.pt", weights_only=True)
    for case, k in CASES.items():
        cfg = ModelConfig(backbone="resnet18", align_offset_clamp=CLAMP, bn_stats_images=k)
        model = S2ANet.from_config(cfg)
        model.load_state_dict(weights)
        model.channels_last().train()
        optimizer = Optimizer(model, build_lr_schedule(**SCHEDULE))
        ema = ModelEMA(model)
        grads, codes = _first_grads(model, optimizer), []
        items = []
        for i, batch in enumerate(_batches(case)):
            with _assignment(codes if i == 0 else []):
                items.append(train_step(model, optimizer, ema, to_device(
                    {key: v[part] for key, v in batch.items()}, "cpu", torch.float32),
                    cfg).numpy())
        state = torch.cat([v.float().reshape(-1) for m in (model, ema.module)
                           for v in m.state_dict().values()])
        ref = state.clone()
        dist.broadcast(ref, 0)
        res = {"replicas_equal": torch.equal(state, ref), "count": optimizer.count,
               "codes": codes}
        if rank == 0:
            res.update(items=np.stack(items), model=model.state_dict(),
                       ema=ema.module.state_dict(), grads=grads)
        torch.save(res, out / f"{case}.{rank}.pt")
    mesh.shutdown()


class _World:
    def __init__(self, out, procs):
        self.out, self.procs = out, procs

    def result(self, case):
        if self.procs is not None:
            join_world(self.procs, timeout=300)
            self.procs = None
        return [torch.load(self.out / f"{case}.{r}.pt", weights_only=False)
                for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
    from s2anet_tpu_torch.models.convert import state_dict_from_jax

    out = tmp_path_factory.mktemp("ddp_step")
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15, align_offset_clamp=CLAMP)
    variables = jax.device_get(jax.jit(lambda key, x: jmodel.init(key, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32)))
    torch.save(state_dict_from_jax(variables, "resnet18"), out / "weights.pt")
    w = _World(out, start_world(_step_world, str(out / "store"), out))
    w.variables = variables
    yield w
    if w.procs is not None:  # no test read it: end the ranks all the same
        join_world(w.procs, timeout=300)


_JAX_STEPS = {}  # bn_stats_images -> (tx, jitted mesh step)


def _jax_run(variables, case):
    """The JAX state after the case's two steps on a 2-device mesh, and the
    loss items of each step."""
    import jax
    import jax.numpy as jnp

    from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
    from s2anet_tpu.parallel.mesh import make_mesh, replicate_state, shard_batch
    from s2anet_tpu.parallel.step import make_train_step
    from s2anet_tpu.train.optim import build_optimizer
    from s2anet_tpu.train.schedule import build_lr_schedule as jax_schedule
    from s2anet_tpu.train.state import create_train_state
    from s2anet_tpu.utils.config import ModelConfig as JaxModelConfig

    k = CASES[case]
    mesh2 = make_mesh(WORLD)
    if k not in _JAX_STEPS:
        jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15,
                           align_offset_clamp=CLAMP, bn_stats_images=k)
        tx = build_optimizer(jax_schedule(**SCHEDULE), params_example=variables["params"],
                             grad_clip_norm=35.0)
        _JAX_STEPS[k] = tx, make_train_step(
            jmodel, tx, imgs_size=(IMG, IMG), num_classes=15,
            model_cfg=JaxModelConfig(backbone="resnet18", align_offset_clamp=CLAMP),
            compute_dtype=jnp.float32, mesh=mesh2, donate=False)
    tx, jstep = _JAX_STEPS[k]
    state = replicate_state(mesh2, create_train_state(
        variables["params"], variables["batch_stats"], tx))
    items = []
    for batch in _batches(case):
        state, it = jstep(state, shard_batch(mesh2, batch))
        items.append(np.asarray(it))
    return jax.device_get(state), np.stack(items)


def _close_trees(got, want, what):
    import jax

    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(np.asarray(flat[path]), np.asarray(w),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_steps_match_jax_mesh_step(world, case):
    from s2anet_tpu.models.torch_import import convert_reference_s2anet

    state, want = _jax_run(world.variables, case)
    ranks = world.result(case)
    assert ranks[1]["replicas_equal"] and ranks[0]["count"] == int(state.step) == 2
    np.testing.assert_allclose(ranks[0]["items"], want, rtol=1e-4)
    now = convert_reference_s2anet(ranks[0]["model"], "resnet18")
    _close_trees(now["params"], state.params, "params")
    _close_trees(now["batch_stats"], state.batch_stats, "batch_stats")
    avg = convert_reference_s2anet(ranks[0]["ema"], "resnet18")
    _close_trees(avg["params"], state.ema_params, "ema params")
    _close_trees(avg["batch_stats"], state.ema_batch_stats, "ema batch_stats")

    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count
    codes = [torch.cat([r["codes"][i] for r in ranks]) for i in range(2)]  # FAM, ODM
    want_g = _one_process_grads(torch.load(world.out / "weights.pt", weights_only=True), case,
                                codes)
    torch.set_num_threads(threads)
    got_g = ranks[0]["grads"]
    assert got_g.keys() == want_g.keys()
    each, whole = (1e-4, 1e-5) if case == "stats_images_1" else (5e-2, 1e-2)
    for name, g in want_g.items():
        assert (got_g[name] - g).norm() <= each * g.norm(), name
    flat = [torch.cat([t[n].reshape(-1) for n in want_g]) for t in (got_g, want_g)]
    assert (flat[0] - flat[1]).norm() <= whole * flat[1].norm()
