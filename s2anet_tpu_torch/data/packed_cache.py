"""Packed pre-decoded image cache: one mmap-able shard file per dataset.

A copy of ``s2anet_tpu/data/packed_cache.py`` with the same on-disk format,
so the port reads a pack the JAX package built and the other way round:

  * ``images.pack.bin``: every decoded **BGR** uint8 image back to back,
    each record padded to 4096 bytes;
  * ``images.pack.idx.npz``: offsets, shapes and a content key (a SHA-1
    over each source image's path, mtime and size), so a re-chipped dataset
    invalidates the pack.

:meth:`PackedImageCache.build` takes the decoder from its caller (the JAX
package defaults to ``cv2.imread``; the port has no cv2). Reads are one
copy-on-write ``np.memmap`` view per image.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

_ALIGN = 4096  # page alignment for each image record


def _content_key(paths: Sequence[Path]) -> str:
    h = hashlib.sha1()
    for p in paths:
        p = Path(p)
        if p.exists():
            st = p.stat()
            h.update(f"{p}:{st.st_mtime_ns}:{st.st_size}|".encode())
        else:
            h.update(f"{p}:missing|".encode())
    return h.hexdigest()


class PackedImageCache:
    """Build-once / mmap-forever decoded-image store."""

    def __init__(self, img_files: Sequence[Path], cache_dir: Optional[Path] = None):
        self.img_files = [Path(p) for p in img_files]
        base = Path(cache_dir) if cache_dir else (
            self.img_files[0].parent if self.img_files else Path(".")
        )
        self.bin_path = base / "images.pack.bin"
        self.idx_path = base / "images.pack.idx.npz"
        self._mm = None
        self._offsets = None
        self._shapes = None

    def valid(self) -> bool:
        """True when the pack exists and matches the current source images."""
        if not (self.idx_path.exists() and self.bin_path.exists()):
            return False
        z = np.load(self.idx_path, allow_pickle=False)
        if str(z["key"]) != _content_key(self.img_files):
            return False
        return self.bin_path.stat().st_size >= int(z["offsets"][-1])

    def build(self, decode: Callable[[Path], np.ndarray]) -> None:
        """Decode every image once with ``decode(path) -> [H, W, 3] BGR
        uint8`` and write the pack (nothing to do when it is valid)."""
        if self.valid():
            return
        n = len(self.img_files)
        offsets = np.zeros(n + 1, np.int64)
        shapes = np.zeros((n, 3), np.int32)
        with open(self.bin_path, "wb") as f:
            pos = 0
            for i, p in enumerate(self.img_files):
                img = np.ascontiguousarray(decode(p), dtype=np.uint8)
                size = -(-img.nbytes // _ALIGN) * _ALIGN
                shapes[i] = img.shape
                offsets[i] = pos
                f.write(img.tobytes())
                f.write(b"\0" * (size - img.nbytes))
                pos += size
            offsets[n] = pos
        np.savez(self.idx_path, key=np.str_(_content_key(self.img_files)),
                 offsets=offsets, shapes=shapes)
        self._mm = None  # re-open on next get

    def _ensure_open(self):
        if self._mm is None:
            z = np.load(self.idx_path, allow_pickle=False)
            self._offsets = z["offsets"]
            self._shapes = z["shapes"]
            # copy-on-write: views are writable, the file never changes
            self._mm = np.memmap(self.bin_path, dtype=np.uint8, mode="c")

    def shape(self, i: int):
        """``(h, w, c)`` of image i."""
        self._ensure_open()
        return tuple(int(v) for v in self._shapes[i])

    def get(self, i: int) -> np.ndarray:
        """Image i as a zero-copy BGR uint8 view into the pack (writes stay
        in memory)."""
        h, w, c = self.shape(i)
        off = int(self._offsets[i])
        return self._mm[off: off + h * w * c].reshape(h, w, c)

    def __len__(self):
        return len(self.img_files)
