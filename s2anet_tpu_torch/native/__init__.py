"""The port's host C++ libraries, built by the host compiler on first use
and loaded with ``ctypes``: the polygon library (``polyiou.cpp``) and the
PNG row unfilter (``png.cpp``, :mod:`..data.image`).

``AVAILABLE`` is decided once, at import, from whether a host C++ compiler
is on the path: where it is, every caller in the port uses these
libraries, and a build that starts and fails raises; where it is not, they
use the NumPy loops of :mod:`..ops.polyiou` and :mod:`..data.image`. Each
library is built with the JAX package's flags into
``build/s2anet_tpu_torch/`` (never beside the source), under a name that
hashes the source and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from .._ext import BUILD_DIR, host_cxx

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "polyiou.cpp")
PNG_SRC = os.path.join(HERE, "png.cpp")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
AVAILABLE = host_cxx() is not None

_lock = threading.Lock()
_libs = {}
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _build(src: str) -> ctypes.CDLL:
    """Build ``src`` (once per source and flags) and load it."""
    cxx = host_cxx()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on the path")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(FLAGS).encode()).hexdigest()
    stem = os.path.splitext(os.path.basename(src))[0]
    out = BUILD_DIR / f"{stem}-{digest[:12]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([cxx, *FLAGS, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{cxx} failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
    return ctypes.CDLL(str(out))


def library() -> ctypes.CDLL:
    """The polygon library, built and loaded once."""
    with _lock:
        if "polyiou" not in _libs:
            lib = _build(SRC)
            lib.iou_poly.restype = ctypes.c_double
            lib.iou_poly.argtypes = [_DP, ctypes.c_int, _DP, ctypes.c_int]
            lib.rbox_iou_matrix.restype = None
            lib.rbox_iou_matrix.argtypes = [_DP, ctypes.c_int64, _DP, ctypes.c_int64, _DP]
            lib.poly_nms.restype = ctypes.c_int64
            lib.poly_nms.argtypes = [_DP, _DP, ctypes.c_int64, ctypes.c_double, _IP]
            _libs["polyiou"] = lib
        return _libs["polyiou"]


def png_library() -> ctypes.CDLL:
    """The PNG unfilter library, built and loaded once."""
    with _lock:
        if "png" not in _libs:
            lib = _build(PNG_SRC)
            lib.png_unfilter.restype = ctypes.c_int64
            lib.png_unfilter.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, _U8P]
            _libs["png"] = lib
        return _libs["png"]


def _f64(a, cols: int) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).reshape(-1, cols)


def iou_poly(p1, p2) -> float:
    """IoU of two convex polygons given as ``[N, 2]`` or flat ``[2N]``."""
    a1, a2 = _f64(p1, 2), _f64(p2, 2)
    return float(library().iou_poly(a1.ctypes.data_as(_DP), len(a1),
                                    a2.ctypes.data_as(_DP), len(a2)))


def rbox_iou_matrix(b1, b2) -> np.ndarray:
    """Pairwise IoU ``[N, M]`` of rotated boxes ``[N, 5]`` and ``[M, 5]``."""
    b1, b2 = _f64(b1, 5), _f64(b2, 5)
    out = np.zeros((len(b1), len(b2)), np.float64)
    library().rbox_iou_matrix(b1.ctypes.data_as(_DP), len(b1),
                              b2.ctypes.data_as(_DP), len(b2),
                              out.ctypes.data_as(_DP))
    return out


def poly_nms(polys, scores, thresh: float) -> list:
    """Greedy polygon NMS with the hbb prefilter; kept indices in score order."""
    polys = _f64(polys, 8)
    scores = np.ascontiguousarray(scores, np.float64)
    keep = np.zeros(len(polys), np.int64)
    n = library().poly_nms(polys.ctypes.data_as(_DP), scores.ctypes.data_as(_DP),
                           len(polys), float(thresh), keep.ctypes.data_as(_IP))
    return keep[:n].tolist()


def png_unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Unfilter ``h`` PNG rows (``raw``: the inflated bytes, a filter-type
    byte before each row) into ``[h, row_bytes]`` uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise ValueError(f"PNG data: {raw.size} bytes for {h} rows of {row_bytes}")
    out = np.empty((h, row_bytes), np.uint8)
    r = png_library().png_unfilter(raw.ctypes.data_as(_U8P), h, row_bytes, bpp,
                                   out.ctypes.data_as(_U8P))
    if r < 0:
        raise ValueError(f"PNG row {-r - 1}: filter type above 4")
    return out
