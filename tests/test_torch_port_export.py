"""The serving kernels as custom ops (``ops/library.py``) and ``torch.export``
of the detector (``s2anet_tpu_torch/export.py``), on the CPU.

* The three ops pass ``torch.library.opcheck`` and equal their plain
  versions bit for bit.
* The exported R-18 64^2 program's graph holds the ops (5 AlignConv, one
  NMS mask, one sweep) and no unrolled sweep.
* Saved and reloaded in a child process that imports only
  ``s2anet_tpu_torch.ops.library``, it gives the eager predictor's outputs
  bit for bit.

The export of JAX-trained weights against the JAX ``tools/export.py``
function is in ``test_torch_port_jax_weights.py``, beside the checkpoint.
"""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from s2anet_tpu_torch import export
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.models.anchors import grid_anchors, grid_anchors_on
from s2anet_tpu_torch.ops import deform_conv as dc
from s2anet_tpu_torch.ops import library
from s2anet_tpu_torch.ops import nms_rotated as nms
from s2anet_tpu_torch.predict import S2ANetPredictor
from s2anet_tpu_torch.train.step import INV255

REPO = Path(__file__).resolve().parents[1]

OPS = torch.ops.s2anet
SIZE, BATCH, NC = 64, 2, 2


def _candidates(gen, b, k, valid_share):
    xy = torch.rand(b, k, 2, generator=gen) * 100
    wh = torch.rand(b, k, 2, generator=gen) * 30 + 2
    boxes = torch.cat([xy, wh, torch.rand(b, k, 1, generator=gen) * 3 - 1.5], -1)
    labels = torch.randint(0, 3, (b, k), generator=gen)
    return boxes, labels, torch.rand(b, k, generator=gen) < valid_share


@pytest.mark.parametrize("k", [1, 63, 64, 65, 130])
def test_nms_ops_equal_plain(k):
    gen = torch.Generator().manual_seed(k)
    boxes, labels, valid = _candidates(gen, 3, k, 0.8)
    valid[1, : k // 2] = False  # valid flags that are not a prefix
    valid[2] = False            # an image with none valid
    torch.library.opcheck(OPS.s2a_nms_rotated_mask, (boxes, labels, valid, 0.3))
    mask = OPS.s2a_nms_rotated_mask(boxes, labels, valid, 0.3)
    assert mask.shape == (3, k, (k + 63) // 64) and mask.dtype == torch.int64
    n = nms.last_valid(valid)
    over = nms.overlap_plain(boxes, labels, valid, 0.3, n)
    assert torch.equal(library.unpack_bits(mask, n), over)
    assert not mask[:, n:].any() and not library.unpack_bits(mask, k)[:, :, n:].any()
    torch.library.opcheck(OPS.s2a_nms_rotated_sweep, (mask, valid))
    keep = OPS.s2a_nms_rotated_sweep(mask, valid)
    assert torch.equal(keep, nms.nms_keep_plain(boxes, labels, valid, 0.3))
    assert torch.equal(nms.nms_keep(boxes, labels, valid, 0.3), keep)
    assert not keep[2].any() and keep.sum() > 0


def test_nms_ops_with_none_valid():
    boxes, labels, valid = _candidates(torch.Generator().manual_seed(0), 2, 70, 0.0)
    mask = OPS.s2a_nms_rotated_mask(boxes, labels, valid, 0.5)
    assert not mask.any()
    assert torch.equal(OPS.s2a_nms_rotated_sweep(mask, valid), valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_op_equals_plain(dtype):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 7, 8, generator=gen).to(dtype)
    off = (torch.randn(2, 5, 7, 9, 2, generator=gen) * 2).to(dtype)
    w = torch.randn(3, 3, 8, 16, generator=gen).to(dtype)
    torch.library.opcheck(OPS.s2a_deform_conv2d_fwd, (x, off, w))
    got = OPS.s2a_deform_conv2d_fwd(x, off, w)
    assert got.dtype == dtype and torch.equal(got, dc.deform_conv2d_plain(x, off, w))
    assert torch.equal(dc.deform_conv2d(x, off, w), got)
    # with a gradient wanted: autograd through the plain version, as before
    wr = w.clone().requires_grad_(True)
    dc.deform_conv2d(x, off, wr).float().sum().backward()
    assert wr.grad is not None and wr.grad.abs().sum() > 0


@pytest.mark.parametrize("hw,stride,row0", [((128, 128), 8, 0), ((3, 5), 128, 7),
                                            ((100, 37), 32, 12), ((1, 1), 64, 0)])
def test_anchors_on_the_device_equal_the_numpy_grid(hw, stride, row0):
    """The head makes its anchor grids on the device with torch operations."""
    got = grid_anchors_on("cpu", hw, stride, row0)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), grid_anchors(hw, stride, row0=row0))


@pytest.fixture(scope="module")
def seeded():
    """An R-18 predictor on seeded random weights, its exported program
    saved to disk, and an input batch."""
    cfg = ModelConfig(backbone="resnet18", num_classes=NC, score_thr=0.005,
                      max_per_img=100, pre_nms_cap=256, max_before_nms_per_level=100)
    pred = S2ANetPredictor(cfg, device="cpu", dtype=torch.float32, seed=0)
    program = export.export_serving(export.serving_module(pred), BATCH, SIZE, "cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    return pred, program, imgs


def test_graph_holds_the_ops_and_no_unrolled_sweep(seeded):
    _, program, _ = seeded
    calls = Counter(n.target for n in program.graph.nodes if n.op == "call_function")
    ours = {str(t): c for t, c in calls.items() if str(t).startswith("s2anet.")}
    assert ours == {"s2anet.s2a_deform_conv2d_fwd.default": 5,
                    "s2anet.s2a_nms_rotated_mask.default": 1,
                    "s2anet.s2a_nms_rotated_sweep.default": 1}
    # the plain sweep would unroll into a bitwise op or more a candidate
    bitwise = sum(c for t, c in calls.items() if "bitwise" in str(t) or "logical" in str(t))
    assert bitwise < 16, bitwise
    # no parameter of the model is left to autograd
    assert all(not p.requires_grad for p in program.parameters())
    # the host constants copied in at every call: the ARF expansion's
    # permutation, one a level, as in the eager head
    assert [tuple(c.shape) for c in program.constants.values()
            if not c.is_floating_point()] == [(8, 9)] * 5
    # the anchor grids, cached before the trace, are constants of the
    # program, one a level
    grids = [tuple(c.shape) for c in program.constants.values()
             if c.is_floating_point() and c.dim() == 2 and c.shape[1] == 5]
    assert grids == [((-(-SIZE // s)) ** 2, 5) for s in (8, 16, 32, 64, 128)]


_CHILD = """
import sys
import numpy as np
import torch
import s2anet_tpu_torch.ops.library  # noqa: F401
torch.set_num_threads(int(sys.argv[4]))
program = torch.export.load(sys.argv[1]).module()
out = program(torch.from_numpy(np.load(sys.argv[2])))
np.savez(sys.argv[3], *[t.numpy() for t in out])
print(" ".join(sorted(m for m in sys.modules if m.startswith("s2anet_tpu"))))
"""


def test_reload_without_model_code_is_bit_equal(seeded, tmp_path):
    pred, program, imgs = seeded
    want = pred.predict(imgs)
    assert want[2].sum() > 10
    path = tmp_path / "s2anet.pt2"
    torch.export.save(program, path)
    np.save(tmp_path / "x.npy", imgs.astype(np.float32) * INV255)
    res = subprocess.run([sys.executable, "-c", _CHILD, str(path), str(tmp_path / "x.npy"),
                          str(tmp_path / "out.npz"), str(torch.get_num_threads())],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = res.stdout.split()
    assert "s2anet_tpu_torch.ops.library" in loaded
    assert not [m for m in loaded if m.startswith(("s2anet_tpu_torch.models", "s2anet_tpu."))]
    got = np.load(tmp_path / "out.npz")
    for i, w in enumerate(want):
        assert np.array_equal(got[f"arr_{i}"], w.numpy()), i
    # and in this process, the program as exported
    for g, w in zip(program.module()(torch.from_numpy(imgs.astype(np.float32) * INV255)), want):
        assert torch.equal(g, w)
