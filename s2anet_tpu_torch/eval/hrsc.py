"""HRSC2016 ship-detection scoring: the port's ``s2anet_tpu/eval/hrsc.py``.

Parses HRSC2016 ``Annotation/*.xml`` files (rotated boxes ``mbox_cx``,
``mbox_cy``, ``mbox_w``, ``mbox_h``, ``mbox_ang`` and the ``difficult``
flag, stdlib ``xml.etree``), turns the boxes into polygons and scores
detections with the same VOC evaluation as DOTA
(:func:`.voc_eval.voc_eval_class`). A library function, as in the JAX
package: ``val`` scores against YOLO labels or DOTA ``labelTxt`` files and
does not call it.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from ..ops.polyiou import rbox_vertices_np
from .voc_eval import voc_eval_class

HRSC_CLASSES = ("ship",)


def parse_hrsc_xml(path) -> List[dict]:
    """One HRSC2016 annotation file -> its objects, each ``{"poly" [8],
    "rbox" [5], "difficult", "name"}``; a missing or empty field reads 0."""
    root = ET.parse(str(path)).getroot()
    objs = []
    for obj in root.iter("HRSC_Object"):
        def field(tag):
            el = obj.find(tag)
            return float(el.text) if el is not None and el.text else 0.0

        rbox = np.array([field("mbox_cx"), field("mbox_cy"), field("mbox_w"),
                         field("mbox_h"), field("mbox_ang")])
        poly = rbox_vertices_np(rbox[None])[0].reshape(8)
        objs.append({"poly": poly, "rbox": rbox, "difficult": bool(int(field("difficult"))),
                     "name": "ship"})
    return objs


def load_hrsc_ground_truth(anno_dir, image_ids: Sequence[str]) -> Dict:
    """``{image_id: [(poly[8], difficult)]}`` from ``<anno_dir>/<id>.xml``;
    an image without a file has no objects."""
    gt: Dict[str, list] = {}
    for img_id in image_ids:
        path = Path(anno_dir) / f"{img_id}.xml"
        gt[img_id] = ([(o["poly"], o["difficult"]) for o in parse_hrsc_xml(path)]
                      if path.exists() else [])
    return gt


def evaluate_hrsc(detections, anno_dir, image_ids, ovthresh: float = 0.5,
                  use_07_metric: bool = True):
    """Score ship detections, an iterable of ``(image_id, score, poly[8])``,
    against the annotations of ``image_ids`` in ``anno_dir``; returns the
    :func:`.voc_eval.voc_eval_class` dict (ap, rec, prec, npos, ...)."""
    gt = load_hrsc_ground_truth(anno_dir, image_ids)
    return voc_eval_class(detections, gt, ovthresh, use_07_metric)
