"""The PyTorch port's host-side ops against the JAX package.

Inputs come from a seeded numpy RNG and go through the JAX function and its
counterpart in ``s2anet_tpu_torch``: box geometry, anchor grids, the ARF
table and rotation-invariant pooling, AlignConv offsets and the model
config. Also checks that the port, training slice included, imports nothing
of JAX and catches no kernel failure.
"""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models import anchors as jax_anchors
from s2anet_tpu.ops import deform_conv as jax_deform
from s2anet_tpu.ops import orn as jax_orn
from s2anet_tpu.ops import rbox as jax_rbox
from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import config
from s2anet_tpu_torch.models import anchors
from s2anet_tpu_torch.ops import deform_conv, orn, rbox

PORT = Path(__file__).resolve().parents[1] / "s2anet_tpu_torch"


def _boxes(rng, n):
    return np.stack([
        rng.uniform(0, 300, n), rng.uniform(0, 300, n),
        rng.uniform(4, 80, n), rng.uniform(4, 40, n),
        rng.uniform(-np.pi, np.pi, n),
    ], axis=1).astype(np.float32)


def test_model_config_defaults_match_jax():
    """ModelConfig, DataConfig and EvalConfig: every port field is a JAX
    field with the same default; the class lists and presets are equal."""
    for cls in ("ModelConfig", "DataConfig", "EvalConfig"):
        port = {f.name: f.default for f in dataclasses.fields(getattr(config, cls))}
        ref = {f.name: f.default for f in dataclasses.fields(getattr(jax_config, cls))}
        for name, value in port.items():
            assert name in ref, (cls, name)
            assert value == ref[name], (cls, name)
    assert config.DOTA10_CLASSES == jax_config.DOTA10_CLASSES
    assert config.NAMES_PRESETS == jax_config.NAMES_PRESETS
    assert config.HRSC_CLASSES == jax_config.HRSC_CLASSES


@pytest.mark.parametrize("names,num_classes", [
    (None, None), ("hrsc", None), ("dota-v2.0", 15), (None, 4), (None, 17),
    (("a", "b", "c"), 15), ("DOTA-v1.5", None)])
def test_resolve_names_matches_load_config(names, num_classes):
    """The names preset and names/num_classes rule of ``load_config``."""
    over = {"model": {} if num_classes is None else {"num_classes": num_classes},
            "data": {} if names is None else {"names": names}}
    want = jax_config.load_config(None, over)
    cfg = config.Config()
    if num_classes is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 num_classes=num_classes))
    if names is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, names=names))
    got = config.resolve_names(cfg, names_explicit=names is not None)
    assert tuple(got.data.names) == tuple(want.data.names)
    assert got.model.num_classes == want.model.num_classes
    with pytest.raises(ValueError, match="unknown names preset"):
        config.resolve_names(dataclasses.replace(cfg, data=config.DataConfig(names="dotaa")),
                             names_explicit=True)


def test_norm_angle_matches_jax(rng):
    a = rng.uniform(-10, 10, 1000).astype(np.float32)
    got = rbox.norm_angle(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_rbox.norm_angle(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert (got >= -np.pi / 4 - 1e-6).all() and (got < 3 * np.pi / 4).all()


def test_vertices_and_poly_match_jax(rng):
    b = _boxes(rng, 200)
    got = rbox.rbox_vertices(torch.from_numpy(b)).numpy()
    want = np.asarray(jax_rbox.rbox_vertices(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    got = rbox.rbox_to_poly(torch.from_numpy(b)).numpy()
    want = np.asarray(jax_rbox.rbox_to_poly(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("clip", [16 / 1000, 1e-6])
def test_rboxes_decode_matches_jax(rng, clip):
    anc = _boxes(rng, 300)
    deltas = rng.normal(size=(300, 5)).astype(np.float32) * 2.0
    got = rbox.rboxes_decode(torch.from_numpy(anc), torch.from_numpy(deltas),
                             wh_ratio_clip=clip).numpy()
    want = np.asarray(jax_rbox.rboxes_decode(
        jnp.asarray(anc), jnp.asarray(deltas), wh_ratio_clip=clip))
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-5, atol=1e-3)
    dth = np.asarray(jax_rbox.norm_angle(jnp.asarray(got[:, 4] - want[:, 4]) + 0.1)) - 0.1
    np.testing.assert_allclose(dth, 0.0, atol=1e-5)


@pytest.mark.parametrize("size,stride,scales,ratios,angles", [
    ((16, 16), 8, (4.0,), (1.0,), (0.0,)),
    ((5, 7), 32, (2.0, 4.0), (0.5, 1.0, 2.0), (0.0, 0.7)),
    ((1, 1), 128, (4.0,), (1.0,), (0.0,)),
])
def test_grid_anchors_match_jax(size, stride, scales, ratios, angles):
    got = anchors.grid_anchors(size, stride, scales, ratios, angles)
    want = jax_anchors.grid_anchors(size, stride, scales, ratios, angles)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_orient,n_rot,k", [(1, 8, 3), (8, 8, 3), (4, 4, 1)])
def test_arf_indices_match_jax(n_orient, n_rot, k):
    np.testing.assert_array_equal(orn.arf_indices(n_orient, n_rot, k),
                                  jax_orn.arf_indices(n_orient, n_rot, k))


@pytest.mark.parametrize("shape", [(4, 16, 1, 3, 3), (2, 3, 8, 3, 3)])
def test_rotate_arf_matches_jax(rng, shape):
    w = rng.normal(size=shape).astype(np.float32)
    got = orn.rotate_arf(torch.from_numpy(w), 8).numpy()
    want = np.asarray(jax_orn.rotate_arf(jnp.asarray(w), 8))
    np.testing.assert_array_equal(got, want)


def test_rotation_invariant_pooling_matches_jax(rng):
    x = rng.normal(size=(2, 5, 6, 32)).astype(np.float32)
    got = orn.rotation_invariant_pooling(torch.from_numpy(x), 8).numpy()
    want = np.asarray(jax_orn.rotation_invariant_pooling(jnp.asarray(x), 8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,stride", [(16, 12, 8.0), (1, 1, 128.0)])
def test_align_conv_offsets_match_jax(rng, h, w, stride):
    anc = np.stack([
        rng.uniform(0, w * stride, (2, h * w)),
        rng.uniform(0, h * stride, (2, h * w)),
        rng.uniform(8, 200, (2, h * w)), rng.uniform(8, 100, (2, h * w)),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, h * w)),
    ], -1).astype(np.float32)
    got = deform_conv.align_conv_offsets(torch.from_numpy(anc), (h, w), stride)
    want = np.asarray(jax_deform.align_conv_offsets(jnp.asarray(anc), (h, w), stride))
    assert tuple(got.shape) == want.shape == (2, h, w, 9, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert {"moments.py", "bn.py", "assigner.py", "losses.py", "schedule.py",
            "optim.py", "state.py", "step.py", "__main__.py", "trainer.py",
            "checkpoint.py", "pretrained.py", "yaml_lite.py", "config.py", "augment.py",
            "dota.py", "synth.py", "callbacks.py", "loggers.py",
            "runner.py", "quant.py", "conv.py", "convert.py", "export.py",
            "library.py", "flops.py", "profiler.py", "profile_report.py",
            "quant_scope_bench.py", "visualize.py"} <= {f.name for f in files}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/step.py",
            "parallel/rows.py", "parallel/spatial.py", "ops/library.py", "utils/flops.py",
            "utils/profiler.py", "tools/profile_report.py", "tools/quant_scope_bench.py",
            "tools/visualize.py"} <= {
        f"{f.parent.name}/{f.name}" for f in files}
    banned = ("jax", "jaxlib", "flax", "optax", "yaml", "cv2", "matplotlib", "s2anet_tpu")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, f"{f}: imports {mod}"


def test_wrappers_have_no_try():
    """A failed kernel build or launch on a CUDA tensor raises: no module of
    the port (wrappers, the models and the train step that call them)
    catches it to run the plain version instead."""
    files = sorted(PORT.rglob("*.py"))
    assert {"moments.py", "bn.py", "step.py", "__main__.py", "trainer.py",
            "loggers.py", "quant.py", "export.py"} <= {f.name for f in files}
    assert {"parallel/mesh.py", "parallel/step.py", "parallel/rows.py",
            "parallel/spatial.py", "ops/library.py", "utils/flops.py", "utils/profiler.py",
            "tools/profile_report.py", "tools/quant_scope_bench.py",
            "tools/visualize.py"} <= {f"{f.parent.name}/{f.name}" for f in files}
    for f in files:
        tree = ast.parse(f.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), f
