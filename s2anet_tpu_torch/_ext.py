"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled on first use by ``nvcc`` into a shared
library with a plain C interface, ``build/s2anet_tpu_torch/<name>-<hash>.so``
under the checkout, and loaded with ``ctypes``. The hash covers the source
and the flags, so an edited source rebuilds. Nothing is fetched; nothing is
compiled when a module is imported.

Every C entry point returns a ``cudaError_t``; :class:`Kernel` raises on a
non-zero code and counts its launches, so a run can show that a path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "s2anet_tpu_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: registers, shared memory and spills of each kernel, which
# chip_smoke.py prints
BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# per-source extra flags: the rotated-IoU tie-breaks need products that round
# exactly as the reference formula does, so no fused multiply-adds there
EXTRA_FLAGS = {"iou_nms_rotated": ["--fmad=false"]}

_libs: dict = {}
_lock = threading.Lock()  # guards _locks
_locks: dict = {}         # name -> lock held while that library builds
# name -> (seconds, nvcc output) of the builds this process ran
build_log: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source on first use")
    return found


def library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        flags = ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])
        digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode())
        out = BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builders agree
            build_log[name] = (time.perf_counter() - t0,
                               proc.stdout + proc.stderr)
        lib = ctypes.CDLL(str(out))
        lib.s2a_error_string.argtypes = [ctypes.c_int]
        lib.s2a_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def build(names) -> None:
    """Build and load several libraries at once, one ``nvcc`` for each."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for future in [pool.submit(library, n) for n in names]:
            future.result()


class Kernel:
    """One C entry point of a library in ``csrc/``, with a launch count.

    ``argtypes`` are ctypes types; pointers and the stream are
    ``c_void_p`` (pass ``tensor.data_ptr()`` and
    ``torch.cuda.current_stream().cuda_stream``).
    """

    def __init__(self, library_name: str, symbol: str, argtypes):
        self.library_name = library_name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def build(self):
        if self._fn is None:
            lib = library(self.library_name)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
            self._err = lib.s2a_error_string
        return self._fn

    def __call__(self, *args) -> None:
        rc = self.build()(*args)
        if rc != 0:
            msg = self._err(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: cudaError {rc} ({msg})")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def host_cxx():
    """The host C++ compiler (``g++``, else ``c++``), or None."""
    return shutil.which("g++") or shutil.which("c++")
