"""The port's synthetic-data writer against ``tools/gen_synth.py``.

With the same seed and flags (the sparse set and ``--dense``) the label
files are the same bytes and the draws stay in step; the painted pixels
differ from ``cv2.fillPoly``'s only on polygon edges: each differing pixel
lies within one pixel of a drawn polygon's boundary, and they are 0.28% of
the pixels of the sparse set and 3.3% of the dense set (100-140 small
polygons a chip, seed 0). The PNG that ``write_png`` writes decodes (cv2)
to the chip, and its ``.npy`` sidecar is the chip in BGR.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from s2anet_tpu_torch.data import synth

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import gen_synth  # noqa: E402


def _edge_band(shape, label_lines, size):
    """Pixels within one pixel of any labelled polygon's boundary."""
    band = np.zeros(shape[:2], bool)
    for line in label_lines:
        pts = np.round(np.array(line.split()[1:], float).reshape(4, 2) * size).astype(np.int64)
        inside = np.zeros(shape[:2] + (1,), np.uint8)
        synth.fill_convex(inside, pts, 1)
        m = inside[..., 0].astype(bool)
        grown = m.copy()
        shrunk = m.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sh = np.roll(np.roll(m, dy, 0), dx, 1)
                grown |= sh
                shrunk &= sh
        band |= grown & ~shrunk
    return band


@pytest.mark.parametrize("dense,share", [(False, 0.0028), (True, 0.033)])
def test_synth_matches_gen_synth(dense, share):
    if dense:
        args = dict(num_classes=8, max_boxes=140, min_boxes=100, box_scale=(0.04, 0.11),
                    crowd=True)
    else:
        args = dict(num_classes=3, max_boxes=3, min_boxes=1, box_scale=(0.15, 0.38),
                    crowd=False)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    n_diff = n_px = 0
    for _ in range(20):
        want, want_lines = gen_synth.synth_image(r1, 256, **args)
        got, got_lines = synth.synth_image(r2, 256, **args)
        assert "\n".join(got_lines) == "\n".join(want_lines)
        diff = (got != want).any(-1)
        assert not (diff & ~_edge_band(got.shape, got_lines, 256)).any()
        n_diff += diff.sum()
        n_px += diff.size
    assert r1.uniform() == r2.uniform()
    assert n_diff / n_px == pytest.approx(share, abs=share * 0.1)


def test_written_split_labels_and_images(tmp_path):
    synth.main(["--out", str(tmp_path / "port"), "--n-train", "3", "--n-val", "2",
                "--img-size", "96"])
    rng = np.random.default_rng(0)
    gen_synth.write_split(tmp_path / "jax" / "train", 3, rng, 96, 3, 3)
    gen_synth.write_split(tmp_path / "jax" / "val", 2, rng, 96, 3, 3)
    for split, n in (("train", 3), ("val", 2)):
        for i in range(n):
            name = f"im{i:05d}"
            port = tmp_path / "port" / split
            assert ((port / "labels" / f"{name}.txt").read_bytes()
                    == (tmp_path / "jax" / split / "labels" / f"{name}.txt").read_bytes())
            bgr = np.load(port / "images" / f"{name}.npy")
            np.testing.assert_array_equal(cv2.imread(str(port / "images" / f"{name}.png")), bgr)
            assert ((port / "images" / f"{name}.npy").stat().st_mtime
                    >= (port / "images" / f"{name}.png").stat().st_mtime)
