"""Spatial serving, the port against the JAX package: R-18, 3 classes, one
256x256 image (one stride-128 row a rank), float32, the same weights through
``models/convert.py``, ``max_per_img=32, pre_nms_cap=128,
max_before_nms_per_level=64``, at AlignConv clamp 0 (the gathered level)
and 6.0 (the halo exchange on P3, gathered P4-P7).

The port on 1 rank (in this process) and on 2 gloo ranks (spawned, through
``test_torch_port_spatial``'s JAX-free workers) against JAX
``make_spatial_eval_step(..., mesh=make_mesh(2), compute_dtype=float32)``
on the image scaled as ``predict.py`` scales it: ``valid`` and labels
equal, boxes within rtol 1e-4 / atol 1e-3 (JAX's own bar for its sharded
against its single-device result, ``tests/test_parallel.py``). One JAX
compile per clamp.

Random-weight scores all sit within ~1e-5 of sigmoid(prior bias), closer
than the two packages' float32 rounding can be trusted to order them, so
the ODM classification head's kernel is scaled by 100 (its logits spread
over a few units) and the threshold sits in a gap of the scores: between
10 and 28 candidates pass, none near it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.parallel.mesh import make_mesh
from s2anet_tpu.parallel.spatial import make_spatial_eval_step, shard_image
from s2anet_tpu.utils.config import ModelConfig as JaxModelConfig
from s2anet_tpu_torch.models.convert import save_jax_npz
from s2anet_tpu_torch.parallel import spatial
from test_torch_port_spatial import (_detect_world, detector, gap_threshold, one_thread,  # noqa: F401
                                     run_world)

SIZE = 256
LIMITS = dict(max_per_img=32, pre_nms_cap=128, max_before_nms_per_level=64)


def _assert_same(got, want):
    gb, gl, gv = (np.asarray(t) for t in got)
    wb, wl, wv = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("clamp", [0.0, 6.0])
def test_spatial_matches_jax_make_spatial_eval_step(tmp_path, clamp, one_thread):
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=3, align_offset_clamp=clamp)
    variables = jax.device_get(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))
    cls = variables["params"]["head"]["odm_cls_head"]
    cls["kernel"] = np.asarray(cls["kernel"]) * 100.0
    save_jax_npz(tmp_path / "w.npz", variables)
    img = np.random.default_rng(3).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    np.save(tmp_path / "img.npy", img)

    port = detector(clamp, str(tmp_path / "w.npz"))
    x = port.to_input(img)
    with torch.no_grad():
        thr = gap_threshold(port.forward(x))
    one_rank = spatial.spatial_predict(port.forward, x, **dict(port.post_kwargs(),
                                                               score_thr=thr))

    mc = JaxModelConfig(num_classes=3, score_thr=thr, align_offset_clamp=clamp, **LIMITS)
    step, mesh = make_spatial_eval_step(jmodel, mesh=make_mesh(2), model_cfg=mc,
                                        compute_dtype=jnp.float32)
    want = step(variables, shard_image(mesh, np.float32(img) / 255.0))
    assert 5 <= int(np.asarray(want[2]).sum()) <= 28

    run_world(_detect_world, 2, tmp_path, str(tmp_path), clamp, str(tmp_path / "w.npz"),
              str(tmp_path / "img.npy"), thr)
    two_ranks = torch.load(tmp_path / "dets.pt")["dets"]
    _assert_same(one_rank, want)
    _assert_same(two_ranks, want)
