"""JAX-trained weights into the port: ``tools/jax_to_torch_weights.py``.

A JAX R-18 train state (two classes, EMA weights apart from the model's,
non-trivial BatchNorm statistics, an ODM class head whose scores spread
over (0, 1)) is saved as the JAX trainer saves it: ``weights/last`` with
its ``.meta.json`` sidecar, the same state without the sidecar, and its
``strip_for_deploy``. The tool tells the layouts apart by what is on disk
and writes the ``.npz`` the port reads; the port's predictor on it gives
the JAX model's head outputs within 2e-3 and its detections to >= 95% 1:1
matches, the EMA weights by default and the model's under ``--no-ema``;
``python -m s2anet_tpu_torch.export`` on it matches the JAX
``tools/export.py::build_inference_fn`` function (jitted) to >= 95% 1:1.
"""

import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.head import s2anet_get_bboxes as jax_get_bboxes
from s2anet_tpu.train.checkpoint import save_checkpoint, strip_for_deploy
from s2anet_tpu.train.optim import build_optimizer
from s2anet_tpu.train.state import create_train_state
from s2anet_tpu.utils.config import load_config as jax_load_config
from s2anet_tpu_torch import export
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.models.convert import load_jax_npz
from s2anet_tpu_torch.models.head import s2anet_get_bboxes
from s2anet_tpu_torch.predict import S2ANetPredictor
from s2anet_tpu_torch.train.step import INV255

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import jax_to_torch_weights as tool  # noqa: E402
from export import build_inference_fn  # noqa: E402

SIZE, BATCH, NC = 64, 2, 2
KEYS = ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox")
CONFIG = ("model: {backbone: resnet18, num_classes: 2, score_thr: 0.3, max_per_img: 100, "
          "pre_nms_cap: 256, max_before_nms_per_level: 100}\n"
          "data: {img_size: 64}\ntrain: {dtype: float32}\n")


def jax_checkpoint(root: Path):
    """The JAX model and its train state, saved under ``root/weights`` as
    ``last`` (with the trainer's sidecar), ``epoch0`` (none) and
    ``deploy``."""
    rng = np.random.default_rng(7)
    model = JaxS2ANet(backbone_name="resnet18", num_classes=NC, deform_impl="gather")
    variables = jax.device_get(jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x,
                                                            train=False))(
        jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))
    params = variables["params"]
    head = params["head"]["odm_cls_head"]
    # scores spread over (0, 1), not within 1e-4 of the prior 0.01
    head["kernel"] = rng.normal(0, 5.0, head["kernel"].shape).astype(np.float32)
    head["bias"] = np.full(head["bias"].shape, -1.0, np.float32)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.2, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.8, 1.2, a.shape)).astype(np.float32),
        variables["batch_stats"])

    def moved(a):  # the EMA's weights: every leaf a few percent away
        return (np.asarray(a) * (1 + 0.05 * rng.normal(size=np.shape(a)))).astype(np.float32)

    state = create_train_state(params, stats, build_optimizer(lambda _: 0.0,
                                                              params_example=params))
    state = state.replace(ema_params=jax.tree_util.tree_map(moved, params),
                          ema_batch_stats=jax.tree_util.tree_map(moved, stats))
    weights = root / "weights"
    save_checkpoint(weights / "last", state, {"epoch": 0})
    save_checkpoint(weights / "epoch0", state)
    strip_for_deploy(state, weights / "deploy")
    return model, jax.device_get(state)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("jaxckpt")
    model, state = jax_checkpoint(root)
    npz = {}
    for name, src, extra in (("ema", "last", []), ("params", "last", ["--no-ema"]),
                             ("epoch0", "epoch0", []), ("deploy", "deploy", [])):
        out = root / f"{name}.npz"
        tool.main(["--weights", str(root / "weights" / src), "--backbone", "resnet18",
                   "--num-classes", str(NC), "--out", str(out), *extra])
        npz[name] = out
    imgs = np.random.default_rng(3).integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    x = jnp.asarray(imgs.astype(np.float32) * INV255)
    want = {"ema": jax.device_get(apply({"params": state.ema_params,
                                         "batch_stats": state.ema_batch_stats}, x)),
            "params": jax.device_get(apply({"params": state.params,
                                            "batch_stats": state.batch_stats}, x))}
    return root, state, npz, imgs, want


def _port_outputs(npz, imgs):
    pred = S2ANetPredictor(ModelConfig(backbone="resnet18", num_classes=NC), str(npz),
                           device="cpu", dtype=torch.float32)
    return pred.forward(pred.to_input(imgs))


def _max_err(got, want) -> float:
    return max(float(np.abs(g.numpy() - np.asarray(w)).max())
               for key in KEYS for g, w in zip(got[key], want[key]))


def _match_1to1(det_a, lab_a, det_b, lab_b) -> int:
    used = np.zeros(len(det_b), bool)
    matched = 0
    for i in range(len(det_a)):
        cand = np.nonzero(
            (~used) & (lab_b == lab_a[i])
            & (np.abs(det_b[:, 5] - det_a[i, 5]) < 1e-3)
            & (np.linalg.norm(det_b[:, :2] - det_a[i, :2], axis=1) < 1.0))[0]
        if len(cand):
            used[cand[0]] = True
            matched += 1
    return matched


def test_layouts_told_apart_on_disk(ckpt, tmp_path):
    root = ckpt[0] / "weights"
    assert tool.checkpoint_kind(root / "last") == "train_state"  # the sidecar
    assert not (root / "epoch0.meta.json").exists()
    assert tool.checkpoint_kind(root / "epoch0") == "train_state"  # the tree's keys
    assert tool.checkpoint_kind(root / "deploy") == "deploy"
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "other"), {"params": {"w": np.ones(2)}})
    with pytest.raises(SystemExit, match="neither a train state nor a deploy"):
        tool.checkpoint_kind(tmp_path / "other")


def test_npz_holds_ema_by_default_and_params_with_no_ema(ckpt):
    _, state, npz, _, _ = ckpt
    leaves = jax.tree_util.tree_leaves_with_path

    def same(tree, variables):
        flat = dict(leaves(tree))
        return len(flat) == len(leaves(variables)) and all(
            np.array_equal(np.asarray(flat[p]), np.asarray(a)) for p, a in leaves(variables))

    ema = {"params": state.ema_params, "batch_stats": state.ema_batch_stats}
    params = {"params": state.params, "batch_stats": state.batch_stats}
    for name in ("ema", "epoch0", "deploy"):
        assert same(load_jax_npz(npz[name]), ema), name
    assert same(load_jax_npz(npz["params"]), params)
    assert not same(load_jax_npz(npz["params"]), ema)


def test_port_serves_jax_weights(ckpt):
    _, _, npz, imgs, want = ckpt
    got = _port_outputs(npz["ema"], imgs)
    assert _max_err(got, want["ema"]) <= 2e-3
    kw = dict(score_thr=0.3, iou_thr=0.5, max_before_nms_per_level=100, max_per_img=100,
              pre_nms_cap=256)
    det_g, lab_g, val_g = (t.numpy() for t in s2anet_get_bboxes(got, **kw))
    det_w, lab_w, val_w = (np.asarray(t) for t in jax_get_bboxes(
        jax.tree_util.tree_map(jnp.asarray, want["ema"]), **kw))
    for i in range(BATCH):
        a, b = det_g[i][val_g[i]], det_w[i][val_w[i]]
        assert len(b) > 10
        matched = _match_1to1(a, lab_g[i][val_g[i]], b, lab_w[i][val_w[i]])
        assert matched >= 0.95 * max(len(a), len(b)), (i, matched, len(a), len(b))


def test_no_ema_serves_the_model_weights(ckpt):
    _, _, npz, imgs, want = ckpt
    got = _port_outputs(npz["params"], imgs)
    assert _max_err(got, want["params"]) <= 2e-3
    assert _max_err(got, want["ema"]) > 1e-2  # the two weight sets really differ


def test_export_of_jax_weights_matches_jax_inference(ckpt, tmp_path):
    """``python -m s2anet_tpu_torch.export`` on the converted weights
    against ``tools/export.py::build_inference_fn``'s function, jitted (not
    exported), on the same train state: >= 95% of detections 1:1."""
    root, state, npz, _, _ = ckpt
    (tmp_path / "cfg.yaml").write_text(CONFIG)
    summary = export.main(["--config", str(tmp_path / "cfg.yaml"), "--weights",
                           str(npz["ema"]), "--batch-size", str(BATCH),
                           "--device", "cpu", "--out", str(tmp_path / "s2anet.pt2")])
    assert summary["outputs"] == [[BATCH, 100, 6], [BATCH, 100], [BATCH, 100]]
    assert summary["input"] == [BATCH, SIZE, SIZE, 3] and summary["dtype"] == "float32"
    program = torch.export.load(tmp_path / "s2anet.pt2").module()
    x = np.random.default_rng(5).uniform(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    det_g, lab_g, val_g = (t.numpy() for t in program(torch.from_numpy(x)))

    cfg = jax_load_config(str(tmp_path / "cfg.yaml"), {"model": {"deform_impl": "gather"}})
    # build_inference_fn's init, whose values the checkpoint replaces, as
    # the tree it restores into: no second init on the CPU
    like = {"params": state.params, "batch_stats": state.batch_stats}
    with mock.patch.object(JaxS2ANet, "init", lambda *a, **k: like):
        infer = build_inference_fn(cfg, weights=str(root / "weights" / "last"))
    det_w, lab_w, val_w = (np.asarray(t) for t in jax.jit(infer)(jnp.asarray(x)))
    for i in range(BATCH):
        a, b = det_g[i][val_g[i]], det_w[i][val_w[i]]
        assert len(b) > 10
        matched = _match_1to1(a, lab_g[i][val_g[i]], b, lab_w[i][val_w[i]])
        assert matched >= 0.95 * max(len(a), len(b)), (i, matched, len(a), len(b))
