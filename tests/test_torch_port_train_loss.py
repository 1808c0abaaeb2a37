"""The S2ANet training loss and the head's gradients against the JAX package.

* ``compute_s2anet_loss`` on the same head outputs (five levels of a 128^2
  image, padded gts, one image without gts): loss items at 1e-5 and the
  gradients with respect to every output at 1e-5.
* The head in training: the refined anchors carry no gradient, and the
  gradients of the FAM branch (and of the rest of the head) match JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from s2anet_tpu.models.anchors import grid_anchors
from s2anet_tpu.models.head import S2ANetHead as JaxHead
from s2anet_tpu.models.head import compute_s2anet_loss as jax_loss
from s2anet_tpu.ops.rbox import rboxes_decode as jax_decode
from s2anet_tpu_torch.models.convert import head_state_dict_from_jax
from s2anet_tpu_torch.models.head import S2ANetHead, compute_s2anet_loss

STRIDES = (8, 16, 32, 64, 128)
IMG = 128
KEYS = ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox")


def _gts(rng, b=3, g=10, nc=4):
    gtb = np.zeros((b, g, 5), np.float32)
    gtc = np.zeros((b, g), np.int32)
    gtm = np.zeros((b, g), bool)
    for i in range(b - 1):  # the last image has no gt
        n = int(rng.integers(2, g))
        gtb[i, :n] = np.stack([rng.uniform(16, 112, n), rng.uniform(16, 112, n),
                               rng.uniform(16, 60, n), rng.uniform(8, 30, n),
                               rng.uniform(-0.7, 2.3, n)], 1)
        gtc[i, :n] = rng.integers(0, nc, n)
        gtm[i, :n] = True
    return gtb, gtc, gtm


def _outputs(rng, b=3, nc=4):
    out = {k: [] for k in KEYS + ("init_anchors", "refine_anchors")}
    for s in STRIDES:
        hw = IMG // s
        anc = grid_anchors((hw, hw), s)
        out["init_anchors"].append(anc)
        for k, c in (("fam_cls", nc), ("fam_bbox", 5), ("odm_cls", nc), ("odm_bbox", 5)):
            out[k].append((rng.normal(size=(b, hw, hw, c)) * 0.5).astype(np.float32))
        deltas = (rng.normal(size=(b, hw * hw, 5)) * 0.2).astype(np.float32)
        out["refine_anchors"].append(np.asarray(jax_decode(
            jnp.broadcast_to(jnp.asarray(anc)[None], (b, hw * hw, 5)),
            jnp.asarray(deltas), wh_ratio_clip=1e-6)))
    return out


def test_loss_and_output_grads_match_jax(rng):
    nc = 4
    out = _outputs(rng, nc=nc)
    gtb, gtc, gtm = _gts(rng, nc=nc)
    kw = dict(imgs_size=(IMG, IMG), num_classes=nc)

    def f(diff):
        o = {**{k: [jnp.asarray(a) for a in v] for k, v in out.items()}, **diff}
        return jax_loss(o, jnp.asarray(gtb), jnp.asarray(gtc), jnp.asarray(gtm), **kw)

    diff = {k: [jnp.asarray(a) for a in out[k]] for k in KEYS}
    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(diff)

    t = {k: [torch.from_numpy(np.array(a)).requires_grad_(k in KEYS) for a in v]
         for k, v in out.items()}
    total, items = compute_s2anet_loss(t, torch.from_numpy(gtb), torch.from_numpy(gtc),
                                       torch.from_numpy(gtm), **kw)
    np.testing.assert_allclose(items.detach().numpy(), np.asarray(want), rtol=1e-5)
    total.backward()
    for k in KEYS:
        for lvl, (a, g) in enumerate(zip(t[k], grads[k])):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k}[{lvl}]")


def test_head_training_detaches_refined_anchors(rng):
    """ODM loss must not reach the FAM regression branch: the refined
    anchors (and through them the AlignConv offsets) are detached."""
    fc, nc, b = 32, 4, 2
    feats = [rng.normal(size=(b, IMG // s, IMG // s, fc)).astype(np.float32)
             for s in STRIDES]
    gtb, gtc, gtm = _gts(rng, b=b, nc=nc)
    jhead = JaxHead(num_classes=nc, feat_channels=fc, featmap_strides=STRIDES,
                    deform_impl="gather")
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32),
        shapes["params"])

    def f(p):
        o = jhead.apply({"params": p}, [jnp.asarray(x) for x in feats], train=True)
        return jax_loss(o, jnp.asarray(gtb), jnp.asarray(gtc), jnp.asarray(gtm),
                        imgs_size=(IMG, IMG), num_classes=nc)

    (_, want_items), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    want = head_state_dict_from_jax(jax.device_get(jgrads))

    head = S2ANetHead(num_classes=nc, feat_channels=fc, featmap_strides=STRIDES)
    head.load_state_dict(head_state_dict_from_jax(params))
    head.train()
    out = head([torch.from_numpy(x).permute(0, 3, 1, 2) for x in feats])
    assert not any(r.requires_grad for r in out["refine_anchors"])
    assert all(c.requires_grad for c in out["fam_bbox"])
    total, items = compute_s2anet_loss(out, torch.from_numpy(gtb), torch.from_numpy(gtc),
                                       torch.from_numpy(gtm), imgs_size=(IMG, IMG),
                                       num_classes=nc)
    np.testing.assert_allclose(items.detach().numpy(), np.asarray(want_items), rtol=1e-5)
    total.backward()
    got = dict(head.named_parameters())
    assert set(got) == set(want)
    fam = [k for k in got if k.startswith(("fam_reg", "fam_cls"))]
    assert len(fam) == 12  # two 2-conv stacks and two 1x1 heads
    for k, p in got.items():
        a, g = want[k].numpy(), p.grad.numpy()
        scale = max(float(np.abs(a).max()), 1e-3)
        assert float(np.abs(a - g).max()) / scale < 5e-4, k
