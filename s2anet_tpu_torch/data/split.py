"""DOTA chip tiling: the sliding windows of ``s2anet_tpu/data/split.py``.

A ``subsize`` x ``subsize`` window slides with stride ``subsize - gap``
(1024 / gap 200 -> stride 824), the last window of a row or column is
pulled back to the image's edge, and windows past a small image are
zero-padded. Chip names follow ``name__rate__left___up`` so that
:mod:`.merge` can invert the tiling. Only ``rate == 1`` is here (a rescale
needs cv2's bicubic resize); clipping label polygons to the windows and the
offline dataset splitter wait.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

DOTA_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
)
# the strings Python's float() reads (no underscores in DOTA files)
_FLOAT_RE = re.compile(
    r"[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf(inity)?|nan)", re.IGNORECASE)


def parse_dota_label(path) -> List[Dict]:
    """Parse a DOTA labelTxt file -> list of {poly[8], name, difficult};
    header lines (``imagesource:``, ``gsd:``) and lines whose first eight
    fields are not numbers are skipped."""
    objs = []
    for line in Path(path).read_text().splitlines():
        parts = line.strip().split()
        if len(parts) < 9:
            continue
        if not all(_FLOAT_RE.fullmatch(v) for v in parts[:8]):
            continue
        poly = [float(v) for v in parts[:8]]
        difficult = int(parts[9]) if len(parts) > 9 and parts[9].isdigit() else 0
        objs.append({"poly": np.array(poly), "name": parts[8],
                     "difficult": difficult})
    return objs


def window_origins(h: int, w: int, subsize: int, slide: int):
    """Top-left corners of the sliding windows covering an (h, w) image."""
    lefts = list(range(0, max(w - subsize, 0) + 1, slide))
    if lefts[-1] + subsize < w:
        lefts.append(w - subsize)
    ups = list(range(0, max(h - subsize, 0) + 1, slide))
    if ups[-1] + subsize < h:
        ups.append(h - subsize)
    # images smaller than subsize still get one (0, 0) window
    return [(l, u) for u in ups for l in lefts]


def split_image(
    img: np.ndarray,
    name: str,
    subsize: int = 1024,
    gap: int = 200,
    rate: float = 1.0,
    pad: bool = True,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(chip_name, chip)`` covering the image, row by row."""
    if rate != 1.0:
        raise NotImplementedError("split_image: only rate 1.0 (a rescale needs "
                                  "a bicubic resize that the port lacks)")
    h, w = img.shape[:2]
    for left, up in window_origins(h, w, subsize, subsize - gap):
        chip = img[up: up + subsize, left: left + subsize]
        if pad and (chip.shape[0] < subsize or chip.shape[1] < subsize):
            padded = np.zeros((subsize, subsize) + chip.shape[2:], chip.dtype)
            padded[: chip.shape[0], : chip.shape[1]] = chip
            chip = padded
        yield f"{name}__{rate}__{left}___{up}", chip
