"""The C++ polygon library (``polyiou.cpp``), built by the host compiler on
first use and loaded with ``ctypes``.

``AVAILABLE`` is decided once, at import, from whether a host C++ compiler
is on the path: where it is, every caller in the port uses this library,
and a build that starts and fails raises; where it is not, they use the
NumPy loops of :mod:`..ops.polyiou`. The library is built with the JAX
package's flags into ``build/s2anet_tpu_torch/`` (never beside the source),
under a name that hashes the source and the flags.
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

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "polyiou.cpp")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
AVAILABLE = host_cxx() is not None

_lock = threading.Lock()
_lib = None
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int64)


def library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = host_cxx()
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++ or c++) on the path")
        with open(SRC, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"polyiou-{digest[:12]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([cxx, *FLAGS, SRC, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"{cxx} failed on {SRC}:\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(out))
        lib.iou_poly.restype = ctypes.c_double
        lib.iou_poly.argtypes = [_DP, ctypes.c_int, _DP, ctypes.c_int]
        lib.rbox_iou_matrix.restype = None
        lib.rbox_iou_matrix.argtypes = [_DP, ctypes.c_int64, _DP, ctypes.c_int64, _DP]
        lib.poly_nms.restype = ctypes.c_int64
        lib.poly_nms.argtypes = [_DP, _DP, ctypes.c_int64, ctypes.c_double, _IP]
        _lib = lib
        return _lib


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
