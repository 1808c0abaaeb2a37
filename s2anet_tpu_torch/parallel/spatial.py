"""Whole-image inference with the image's height sharded over the ranks.

Counterpart of ``s2anet_tpu/parallel/spatial.py`` (``make_spatial_eval_step``,
``shard_image``). A large scene runs whole, with no tiling seams, no double
detections and no cross-chip merge: each rank (a process of
``parallel/mesh.py``'s group) runs the detector on its own rows, the layers
fetch their halo rows from the neighbouring ranks (``parallel/rows.py``),
and each level's ODM outputs and refined anchors are then gathered whole in
rank order, which is the whole map's row-major order, so that
``s2anet_get_bboxes`` runs unchanged on rank 0: the top-k's tie order and
the NMS are those of the single image. With one rank this is the model's
forward on the image, with no exchange and no copy.

The image's height must divide by 128 (the largest stride) times the
ranks, so every rank holds whole stride-128 rows (``predict --mode
spatial`` pads to it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.head import s2anet_get_bboxes
from . import mesh, rows

MAX_STRIDE = 128
DECODED = ("odm_cls", "odm_bbox", "refine_anchors")  # what the decode reads


def padded_size(h: int, w: int, world: int) -> tuple[int, int]:
    """The image's size padded to the spatial step's multiples: H of 128
    times the ranks, W of 128 (JAX ``predict.py:170-172``)."""
    unit = MAX_STRIDE * world
    return -(-h // unit) * unit, -(-w // MAX_STRIDE) * MAX_STRIDE


def shard_rows(img: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s rows of ``img [B, H, W, C]`` (H divides over
    ``world`` ranks; counterpart of JAX ``shard_image``)."""
    h = img.shape[1]
    if h % world:
        raise ValueError(f"height {h} does not divide over {world} ranks")
    part = h // world
    return img[:, rank * part:(rank + 1) * part]


def check_rows(h_rows: int) -> None:
    """A rank's rows hold whole stride-128 rows: H % (128 * ranks) == 0."""
    world = mesh.world_size()
    if h_rows % MAX_STRIDE:
        raise ValueError(f"H={h_rows * world} must divide by ranks x max stride = "
                         f"{world} x {MAX_STRIDE}")


def _gather(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A level's ``[B, h, w, ...]`` (or ``[B, h*w, ...]``) output of this
    rank's rows -> the whole map's, in the same layout."""
    flat = t.dim() == 3
    t4 = t.reshape(t.shape[0], h, w, -1) if flat else t
    whole = mesh.gather_rows(t4, 1)
    return whole.reshape(t.shape[0], -1, t.shape[-1]) if flat else whole


def spatial_forward(forward, x_rows: torch.Tensor) -> dict:
    """Head outputs of the whole image from this rank's rows
    ``x_rows [B, 3, H / ranks, W]`` (scaled, on the device): ``forward``
    (the model or a predictor's ``forward``) runs on the rows with the
    layers sharded, then every level's ``odm_cls``, ``odm_bbox`` and
    ``refine_anchors`` are gathered whole (on every rank). With one rank,
    ``forward(x_rows)`` itself."""
    check_rows(x_rows.shape[2])
    if mesh.world_size() == 1:
        return forward(x_rows)
    with rows.sharded():
        out = forward(x_rows)
    sizes = [t.shape[1:3] for t in out["odm_cls"]]
    return {k: [_gather(t, h, w) for t, (h, w) in zip(out[k], sizes)] for k in DECODED}


@torch.no_grad()
def spatial_predict(forward, x_rows: torch.Tensor, **post_kwargs):
    """:func:`spatial_forward`, then ``s2anet_get_bboxes`` on rank 0:
    ``(det_boxes, det_labels, det_valid)`` there, None on the other
    ranks."""
    out = spatial_forward(forward, x_rows)
    return s2anet_get_bboxes(out, **post_kwargs) if mesh.is_main_process() else None
