"""Image files without cv2: a PNG and BMP reader that gives what
``cv2.imread(path)`` (``IMREAD_COLOR``) gives, BGR uint8 ``[H, W, 3]``.

* **PNG**, non-interlaced: bit depths 1, 2, 4, 8 and 16 (16 bits keep their
  high byte, as libpng's ``png_set_strip_16`` under cv2 does), colour
  types 0 (grey, replicated), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6
  (RGBA), the alpha dropped; all five row filters. The IDAT stream is
  inflated by ``zlib``; the rows are unfiltered by the host C++ library
  (``native/png.cpp``) where a host compiler is found, else by the NumPy
  loops here (:func:`unfilter_np`, the same bytes; minutes on a 4000 x 4000
  scene of Paeth rows).
* **BMP**, uncompressed (``BI_RGB``): 24 and 32 bits a pixel (the fourth
  byte dropped), and 1, 4 and 8 bits through the palette; bottom-up and
  top-down.

Any other file (an interlaced PNG, JPEG, TIFF, WebP, a compressed BMP) goes
to PIL where PIL is installed (:data:`HAVE_PIL`), converted to RGB and
flipped to BGR; without PIL, :func:`imread` raises :class:`NoReader`,
naming the file and the formats it reads. :func:`image_shape` reads ``(h,
w)`` from a PNG or BMP header without decoding. This module alone decides
which reader serves which file: the loaders call :func:`imread` and
:func:`read_shape`.
"""

from __future__ import annotations

import importlib.util
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import native

HAVE_PIL = importlib.util.find_spec("PIL") is not None
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
FORMATS = "PNG (not interlaced) and uncompressed BMP"
# formats PIL is asked to read, by their leading bytes: JPEG, TIFF (both
# byte orders), WebP (RIFF....WEBP), GIF
_PIL_MAGIC = (b"\xff\xd8\xff", b"II*\x00", b"MM\x00*", b"RIFF", b"GIF8")
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


class NoReader(FileNotFoundError):
    """An image file of a format that only PIL reads, where PIL is absent:
    no decoded form of it is found."""

    def __init__(self, path):
        super().__init__(
            f"{path}: no decoded form of this image. Without PIL the port reads "
            f"{FORMATS} files, the BGR .npy sidecar beside the image (newer than "
            f"it) or a packed shard images.pack.bin (cache_images='packed'), as "
            f"the JAX package writes them")


def _u32(b: bytes, at: int) -> int:
    return struct.unpack_from(">I", b, at)[0]


def _png_header(head: bytes):
    """``(w, h, bit_depth, colour_type, interlace)`` from a PNG's first 33
    bytes (signature and IHDR), or None where they are not a PNG's."""
    if len(head) < 33 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, _, _, interlace = struct.unpack_from(">IIBBBBB", head, 16)
    return w, h, depth, ctype, interlace


def _bmp_header(head: bytes):
    """``(offset, w, h, bits, compression, colours, dib_size)`` of a BMP
    (``h`` negative: top-down rows), or None."""
    if len(head) < 26 or head[:2] != b"BM":
        return None
    offset, dib = struct.unpack_from("<II", head, 10)
    if dib == 12:  # BITMAPCOREHEADER
        w, h, _, bits = struct.unpack_from("<HhHH", head, 18)
        return offset, w, h, bits, 0, 0, dib
    if len(head) < 50:
        return None
    w, h, _, bits, comp = struct.unpack_from("<iiHHI", head, 18)
    colours = struct.unpack_from("<I", head, 46)[0]
    return offset, w, h, bits, comp, colours, dib


def _reads_png(hdr) -> bool:
    w, h, depth, ctype, interlace = hdr
    return interlace == 0 and depth in _PNG_DEPTHS.get(ctype, ()) and w > 0 and h > 0


def _reads_bmp(hdr) -> bool:
    _, w, h, bits, comp, _, _ = hdr
    return comp == 0 and bits in (1, 4, 8, 24, 32) and w > 0 and h != 0


def _head(path) -> bytes:
    with open(path, "rb") as f:
        return f.read(64)


def image_shape(path) -> Optional[Tuple[int, int]]:
    """``(h, w)`` from the header of a PNG or BMP file (any PNG, interlaced
    too), without decoding; None for another file."""
    head = _head(path)
    png = _png_header(head)
    if png is not None:
        return png[1], png[0]
    bmp = _bmp_header(head)
    if bmp is not None:
        return abs(bmp[2]), bmp[1]
    return None


def unfilter_np(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The PNG row unfilter in NumPy: ``raw`` holds ``h`` rows, each a
    filter-type byte and ``row_bytes`` filtered bytes; returns ``[h,
    row_bytes]`` uint8. Sub and Up run as vector operations, Average and
    Paeth one pixel at a time."""
    rows = np.asarray(raw, np.uint8)[: h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    pad = (-row_bytes) % bpp
    for r in range(h):
        t, f = int(rows[r, 0]), rows[r, 1:]
        if t == 0:
            cur = f.copy()
        elif t == 1:
            px = np.concatenate([f, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(px, 0, dtype=np.uint8).reshape(-1)[:row_bytes]
        elif t == 2:
            cur = f + prev
        elif t in (3, 4):
            cur = np.zeros(row_bytes + bpp, np.int32)  # bpp zeros on the left
            up = np.concatenate([np.zeros(bpp, np.int32), prev.astype(np.int32)])
            fi = f.astype(np.int32)
            for x in range(0, row_bytes, bpp):
                n = min(bpp, row_bytes - x)
                a, b = cur[x:x + n], up[x + bpp:x + bpp + n]
                if t == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x:x + n]
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x + bpp:x + bpp + n] = (fi[x:x + n] + pred) & 0xFF
            cur = cur[bpp:].astype(np.uint8)
        else:
            raise ValueError(f"PNG row {r}: filter type {t} above 4")
        out[r] = prev = cur
    return out


def unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """:func:`unfilter_np` in the host C++ library where it is built."""
    if native.AVAILABLE:
        return native.png_unfilter(raw, h, row_bytes, bpp)
    return unfilter_np(raw, h, row_bytes, bpp)


def _unpack_bits(rows: np.ndarray, depth: int, w: int) -> np.ndarray:
    """``[h, row_bytes]`` of ``depth``-bit samples (1, 2, 4) -> ``[h, w]``."""
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :w]


def png_chunks(data: bytes):
    """A PNG's compressed image data (its IDAT chunks joined) and its
    palette (``[n, 3]`` RGB, or None), by walking its chunks."""
    idat, palette, pos = [], None, 8
    while pos + 8 <= len(data):
        n = _u32(data, pos)
        tag = data[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        elif tag == b"PLTE":
            palette = np.frombuffer(data[pos + 8:pos + 8 + n], np.uint8).reshape(-1, 3)
        elif tag == b"IEND":
            break
        pos += n + 12
    return b"".join(idat), palette


def png_stream(data: bytes, name="PNG"):
    """A non-interlaced PNG's header ``(w, h, bit_depth, colour_type)``,
    palette (``[n, 3]`` RGB or None), inflated rows (a filter-type byte
    before each), bytes a row and bytes a pixel (at least 1)."""
    hdr = _png_header(data[:33])
    if hdr is None or not _reads_png(hdr):
        raise ValueError(f"{name}: not a PNG this reader decodes ({FORMATS})")
    w, h, depth, ctype, _ = hdr
    idat, palette = png_chunks(data)
    ch = _PNG_CHANNELS[ctype]
    row_bytes = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data for {h} rows "
                         f"of {row_bytes}")
    return (w, h, depth, ctype), palette, raw, row_bytes, max(1, ch * depth // 8)


def read_png(data: bytes, name="PNG") -> np.ndarray:
    """A non-interlaced PNG's bytes -> BGR uint8 ``[H, W, 3]``."""
    (w, h, depth, ctype), palette, raw, row_bytes, bpp = png_stream(data, name)
    ch = _PNG_CHANNELS[ctype]
    rows = unfilter(raw, h, row_bytes, bpp)
    if depth == 16:  # the high byte of each big-endian sample
        px = rows.reshape(h, w, ch, 2)[..., 0]
    elif depth == 8:
        px = rows.reshape(h, w, ch)
    else:
        px = _unpack_bits(rows, depth, w)[..., None]
        if ctype == 0:  # grey scaled to 8 bits, as libpng expands it
            px = (px.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette image without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return np.ascontiguousarray(lut[px[..., 0]][:, :, ::-1])
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def read_bmp(data: bytes, name="BMP") -> np.ndarray:
    """An uncompressed BMP's bytes -> BGR uint8 ``[H, W, 3]``."""
    hdr = _bmp_header(data[:64])
    if hdr is None or not _reads_bmp(hdr):
        raise ValueError(f"{name}: not a BMP this reader decodes ({FORMATS})")
    offset, w, h, bits, _, colours, dib = hdr
    rows_h = abs(h)
    stride = ((w * bits + 31) // 32) * 4
    need = offset + stride * rows_h
    if len(data) < need:
        raise ValueError(f"{name}: {len(data)} bytes, the header says {need}")
    rows = np.frombuffer(data, np.uint8, stride * rows_h, offset).reshape(rows_h, stride)
    if h > 0:  # bottom-up
        rows = rows[::-1]
    if bits >= 24:
        return np.ascontiguousarray(rows[:, :w * bits // 8].reshape(rows_h, w, bits // 8)[..., :3])
    entry = 3 if dib == 12 else 4
    n = colours or (1 << bits)
    start = 14 + dib
    pal = np.frombuffer(data, np.uint8, n * entry, start).reshape(n, entry)[:, :3]
    lut = np.zeros((256, 3), np.uint8)
    lut[:n] = pal[:256]
    idx = rows[:, :w] if bits == 8 else _unpack_bits(rows, bits, w)
    return np.ascontiguousarray(lut[idx])


def imread(path) -> Optional[np.ndarray]:
    """``cv2.imread(path)``: BGR uint8 ``[H, W, 3]``, or None for a file
    that is not an image (no format this reader or PIL knows by its leading
    bytes, as cv2 returns None). A PNG or BMP this module decodes is read
    here; any other image goes to PIL and, without PIL, raises
    :class:`NoReader`. A damaged file of a known format raises."""
    data = Path(path).read_bytes()
    head = data[:64]
    png, bmp = _png_header(head), _bmp_header(head)
    if png is not None and _reads_png(png):
        return read_png(data, str(path))
    if bmp is not None and _reads_bmp(bmp):
        return read_bmp(data, str(path))
    if png is None and bmp is None and not head.startswith(_PIL_MAGIC):
        return None
    if not HAVE_PIL:
        raise NoReader(path)
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    return np.ascontiguousarray(rgb[:, :, ::-1])


def read_shape(path) -> Optional[Tuple[int, int]]:
    """``cv2.imread(path).shape[:2]`` without decoding where the header
    tells it: a PNG or BMP by :func:`image_shape`, another known format by
    PIL (without it, :class:`NoReader` as :func:`imread` raises); None for
    a file that is not an image."""
    shape = image_shape(path)
    if shape is not None:
        return shape
    if not _head(path).startswith(_PIL_MAGIC):
        return None
    if not HAVE_PIL:
        raise NoReader(path)
    from PIL import Image

    with Image.open(path) as im:
        return im.size[1], im.size[0]
