"""The training slice's host-side pieces against the JAX package.

Seeded numpy inputs through the JAX function and its counterpart in
``s2anet_tpu_torch``: ``rboxes_encode`` (1e-5), the losses (1e-6), the
assignment codes (exactly equal), the LR schedules, the EMA and the
training config fields.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from s2anet_tpu.models import assigner as jax_assigner
from s2anet_tpu.models import losses as jax_losses
from s2anet_tpu.models.anchors import grid_anchors
from s2anet_tpu.ops import rbox as jax_rbox
from s2anet_tpu.train.schedule import build_lr_schedule as jax_schedule
from s2anet_tpu.train.state import create_train_state, ema_update
from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import config
from s2anet_tpu_torch.models import assigner, losses
from s2anet_tpu_torch.models.bn import BatchNorm2d
from s2anet_tpu_torch.ops import iou_rotated, rbox
from s2anet_tpu_torch.train.schedule import build_lr_schedule
from s2anet_tpu_torch.train.state import ModelEMA


def _boxes(rng, n, lo=0.0, hi=300.0):
    return np.stack([
        rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
        rng.uniform(4, 80, n), rng.uniform(4, 40, n),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, n),
    ], axis=1).astype(np.float32)


def test_train_config_defaults_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(config.TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_config.TrainConfig)}
    assert port == ref


def test_rboxes_encode_matches_jax(rng):
    anc = _boxes(rng, 500)
    gt = _boxes(rng, 500)
    got = rbox.rboxes_encode(torch.from_numpy(anc), torch.from_numpy(gt)).numpy()
    want = np.asarray(jax_rbox.rboxes_encode(jnp.asarray(anc), jnp.asarray(gt)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # decode inverts it
    back = rbox.rboxes_decode(torch.from_numpy(anc), torch.from_numpy(got),
                              wh_ratio_clip=1e-6).numpy()
    np.testing.assert_allclose(back[:, :4], gt[:, :4], rtol=1e-4, atol=1e-3)


def test_losses_match_jax(rng):
    logits = (rng.normal(size=(64, 15)) * 4).astype(np.float32)
    targets = (rng.uniform(size=(64, 15)) < 0.2).astype(np.float32)
    for port_fn, jax_fn in ((losses.bce_with_logits, jax_losses.bce_with_logits),
                            (losses.focal_loss_with_logits,
                             jax_losses.focal_loss_with_logits)):
        got = port_fn(torch.from_numpy(logits), torch.from_numpy(targets)).numpy()
        want = np.asarray(jax_fn(jnp.asarray(logits), jnp.asarray(targets)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pred = rng.normal(size=(200, 5)).astype(np.float32) * 0.3
    tgt = rng.normal(size=(200, 5)).astype(np.float32) * 0.3
    got = losses.smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(tgt)).numpy()
    want = np.asarray(jax_losses.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(tgt)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _assign_inputs(rng, b=3, g=12):
    """Anchors of two levels of a 128^2 image, jittered so that some leave
    the image; per image a few real gts (one duplicated: a claim tie), the
    last image without any."""
    anc = np.concatenate([grid_anchors((16, 16), 8), grid_anchors((8, 8), 16)])
    anc = np.repeat(anc[None], b, 0)
    anc = anc + rng.normal(size=anc.shape).astype(np.float32) * [4, 4, 2, 2, 0.2]
    anc[:, :5, 0] = -3.0                       # centre outside
    anc[:, 5:8, 2] = 200.0                     # wider than the image
    gtb = np.zeros((b, g, 5), np.float32)
    gtm = np.zeros((b, g), bool)
    for i in range(b - 1):
        n = int(rng.integers(3, g))
        gtb[i, :n] = _boxes(rng, n, 10, 118)
        gtb[i, n - 1] = gtb[i, 0]              # duplicate gt: the last wins
        gtm[i, :n] = True
    return anc.astype(np.float32), gtb, gtm


def test_assign_labels_codes_equal_jax(rng):
    anc, gtb, gtm = _assign_inputs(rng)
    got = assigner.assign_labels(torch.from_numpy(anc), torch.from_numpy(gtb),
                                 torch.from_numpy(gtm), (128, 128)).numpy()
    for i in range(anc.shape[0]):
        want, _ = jax_assigner.assign_labels(
            jnp.asarray(anc[i]), jnp.asarray(gtb[i]), jnp.asarray(gtm[i]),
            imgs_size=(128, 128), gt_tier=0)
        np.testing.assert_array_equal(got[i], np.asarray(want))
    assert (got[0] >= 0).any() and (got[0] == -1).any() and (got[0] == -2).any()
    assert (got[-1][assigner.valid_anchors(torch.from_numpy(anc[-1]),
                                           (128, 128)).numpy()] == -1).all()
    # shared anchors [A, 5] give the same codes as the batch of copies
    shared = assigner.assign_labels(torch.from_numpy(anc[0]), torch.from_numpy(gtb),
                                    torch.from_numpy(gtm), (128, 128)).numpy()
    np.testing.assert_array_equal(shared[0], got[0])


@pytest.mark.parametrize("shared", [True, False])
def test_assign_labels_one_iou_call_per_stage(rng, shared, monkeypatch):
    """One rotated-IoU call for the batch, shared anchors [A, 5] (the FAM
    stage) or per-image anchors [B, A, 5] (the ODM stage); codes exactly
    equal to JAX's."""
    anc, gtb, gtm = _assign_inputs(rng)
    calls = []

    def counted(a, g):
        calls.append((tuple(a.shape), tuple(g.shape)))
        return iou_rotated.box_iou_rotated_plain(a, g)

    monkeypatch.setattr(assigner, "box_iou_rotated", counted)
    anchors = anc[0] if shared else anc
    got = assigner.assign_labels(torch.from_numpy(anchors), torch.from_numpy(gtb),
                                 torch.from_numpy(gtm), (128, 128)).numpy()
    assert calls == [(anchors.shape, gtb.shape)]
    for i in range(anc.shape[0]):
        want, _ = jax_assigner.assign_labels(
            jnp.asarray(anchors if shared else anchors[i]), jnp.asarray(gtb[i]),
            jnp.asarray(gtm[i]), imgs_size=(128, 128), gt_tier=0)
        np.testing.assert_array_equal(got[i], np.asarray(want))


def test_assign_from_iou_rules_equal_jax(rng):
    """Broken IoUs (< 0, > 1), exact ties between gts, padded columns."""
    iou = rng.uniform(0, 0.7, (40, 6)).astype(np.float32)
    iou[3, 1] = 1.5
    iou[4, 2] = -0.2
    iou[:, 4] = iou[:, 2]                      # gt 4 ties gt 2 everywhere
    iou[7] = 0.45                              # between the thresholds
    valid = rng.uniform(size=40) > 0.1
    gtm = np.array([True, True, True, False, True, False])
    got = assigner.assign_from_iou(torch.from_numpy(iou), torch.from_numpy(valid),
                                   torch.from_numpy(gtm)).numpy()
    want, _ = jax_assigner.assign_from_iou(jnp.asarray(iou), jnp.asarray(valid),
                                           jnp.asarray(gtm))
    np.testing.assert_array_equal(got, np.asarray(want))
    # the best anchor of the tied gts goes to the later one; argmax over
    # gts (IoU >= 0.5) picks the first
    assert got[iou[:, 2].argmax()] == 4 and 2 in got


@pytest.mark.parametrize("schedule", ["step", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 50])
def test_lr_schedule_matches_jax(schedule, warmup):
    kw = dict(lr0=0.01, total_steps=1200, steps_per_epoch=100,
              schedule=schedule, warmup_iters=warmup)
    port, ref = build_lr_schedule(**kw), jax_schedule(**kw)
    steps = [0, 1, 25, 49, 50, 51, 700, 799, 800, 917, 1100, 1199, 1500]
    np.testing.assert_allclose([port(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6)


def test_ema_matches_jax(rng):
    """EMA of parameters and BN running statistics over three updates."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), BatchNorm2d(4))
    ema = ModelEMA(model, decay=0.9999, ramp=2000)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if v.is_floating_point()}
    state = create_train_state({k: jnp.asarray(v) for k, v in sd.items()
                                if "running" not in k},
                               {k: jnp.asarray(v) for k, v in sd.items()
                                if "running" in k},
                               optax.identity())
    for step in (1, 2, 3):
        with torch.no_grad():
            for v in model.state_dict().values():
                if v.is_floating_point():
                    v.add_(torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)))
        ema.update(model, step)
        new = {k: jnp.asarray(v.numpy()) for k, v in model.state_dict().items()
               if v.is_floating_point()}
        state = ema_update(
            state.replace(step=jnp.asarray(step, jnp.int32)),
            {k: v for k, v in new.items() if "running" not in k},
            {k: v for k, v in new.items() if "running" in k})
        # JAX forms the decay in float32, where 1 - exp(-step / 2000) keeps
        # only about 4 digits at the first steps
        np.testing.assert_allclose(ema.decay_at(step),
                                   float(state.ema_decay_at(0.9999, 2000)), rtol=1e-4)
        got = ema.module.state_dict()
        for k, v in {**state.ema_params, **state.ema_batch_stats}.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(ema.module.state_dict()["1.num_batches_tracked"]) == 0
