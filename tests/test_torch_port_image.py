"""The port's cv2-free image code against cv2, on the CPU.

* ``data/image.py`` decodes every PNG and BMP kind below to
  ``cv2.imread``'s pixels bit for bit: PNGs cv2 writes with each of the
  five row filters forced and with its adaptive choice, PNGs PIL writes
  (grey, 1-bit, 2-bit palette, 8-bit palette, grey + alpha, RGBA, 16-bit
  grey), 16-bit colour and BGRA from cv2, sizes that are not multiples of
  8, and :func:`.synth.write_png` files with every filter; 24-bit and
  8-bit palette BMPs, bottom-up and top-down, 1-bit and 32-bit. The C++
  unfilter equals the NumPy one; the header reader equals
  ``cv2.imread(...).shape[:2]``. JPEG goes to PIL, and raises without it;
  a file that is no image reads as None (cv2's answer).
* ``augment.resize_bicubic`` against ``cv2.resize(..., INTER_CUBIC)``: the
  same size, within one level.
* ``utils/plots.py``: the strokes of ``draw_rboxes`` within one pixel of
  ``cv2.polylines``' at thickness 2, both ways, for boxes inside the image.
"""

import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from s2anet_tpu_torch import native
from s2anet_tpu_torch.data import augment, image, synth
from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np
from s2anet_tpu_torch.utils import plots

FILTERS = {0: cv2.IMWRITE_PNG_FILTER_NONE, 1: cv2.IMWRITE_PNG_FILTER_SUB,
           2: cv2.IMWRITE_PNG_FILTER_UP, 3: cv2.IMWRITE_PNG_FILTER_AVG,
           4: cv2.IMWRITE_PNG_FILTER_PAETH}


def _smooth(rng, h, w, c=3):
    """Smooth content with noise: the adaptive filter choice varies."""
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 7.0)[..., None] * 60 + np.cos(y / 5.0)[..., None] * 50 + 120
            + np.arange(c) * 10)
    return np.clip(base + rng.normal(0, 3, (h, w, c)), 0, 255).astype(np.uint8)


def _png_rows(path):
    """The inflated rows of a PNG, its rows, bytes a row and a pixel."""
    (_, h, _, _), _, raw, row_bytes, bpp = image.png_stream(path.read_bytes())
    return raw, h, row_bytes, bpp


def _write_interlaced(path, rgb):
    """An Adam7-interlaced 8-bit RGB PNG (filter 0 on every row)."""
    import zlib

    h, w, _ = rgb.shape
    raw = b""
    for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
                           (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)):
        sub = rgb[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(image.PNG_SIGNATURE
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _top_down(bmp: bytes) -> bytes:
    """A bottom-up BITMAPINFOHEADER BMP rewritten top-down (negative
    height, rows reversed)."""
    offset = struct.unpack_from("<I", bmp, 10)[0]
    w, h, _, bits = struct.unpack_from("<iiHH", bmp, 18)
    stride = ((w * bits + 31) // 32) * 4
    rows = [bmp[offset + r * stride: offset + (r + 1) * stride] for r in range(h)]
    head = bytearray(bmp[:offset])
    struct.pack_into("<i", head, 22, -h)
    return bytes(head) + b"".join(rows[::-1])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``{name: path}`` of every image kind the reader takes."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    bgr = _smooth(rng, 37, 53)
    rgb = np.ascontiguousarray(bgr[:, :, ::-1])
    out = {}

    def cv(name, img, *params):
        cv2.imwrite(str(d / name), img, list(params))
        out[name] = d / name

    def pil(name, im, **kw):
        im.save(d / name, **kw)
        out[name] = d / name

    for t, flag in FILTERS.items():
        cv(f"cv_filter{t}.png", bgr, cv2.IMWRITE_PNG_FILTER, flag)
        synth.write_png(d / f"synth_filter{t}.png", rgb, filters=t)
        out[f"synth_filter{t}.png"] = d / f"synth_filter{t}.png"
    synth.write_png(d / "synth_mixed.png", rgb, filters=rng.integers(0, 5, 37))
    out["synth_mixed.png"] = d / "synth_mixed.png"
    cv("cv_all_filters.png", bgr, cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS)
    cv("cv_grey.png", bgr[..., 0])
    cv("cv_bgra.png", np.dstack([bgr, rng.integers(0, 256, (37, 53), dtype=np.uint8)]))
    cv("cv_16bit.png", (_smooth(rng, 29, 41).astype(np.uint16) * 257
                        + rng.integers(0, 256, (29, 41, 3))).astype(np.uint16))
    cv("cv_16bit_grey.png", rng.integers(0, 65536, (29, 41)).astype(np.uint16))
    cv("cv_noise_odd.png", rng.integers(0, 256, (31, 45, 3), dtype=np.uint8))
    pil("pil_rgb.png", Image.fromarray(rgb))
    pil("pil_grey.png", Image.fromarray(bgr[..., 0]))
    pil("pil_1bit.png", Image.fromarray(bgr[..., 0] > 128))
    pil("pil_palette.png", Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                                        colors=200))
    pil("pil_palette_2bit.png", Image.fromarray(rgb).convert(
        "P", palette=Image.ADAPTIVE, colors=4), bits=2)
    pil("pil_grey_alpha.png", Image.fromarray(np.dstack([bgr[..., 0], bgr[..., 1]]), "LA"))
    pil("pil_rgba.png", Image.fromarray(np.dstack([rgb, bgr[..., 0]]), "RGBA"))
    pil("pil_16bit_grey.png", Image.fromarray(_smooth(rng, 29, 41, 1)[..., 0]
                                              .astype(np.uint16) * 250))
    cv("cv_24.bmp", bgr)
    cv("cv_8.bmp", bgr[..., 0])
    pil("pil_24.bmp", Image.fromarray(rgb))
    pil("pil_8_palette.bmp", Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                                          colors=100))
    pil("pil_1.bmp", Image.fromarray(bgr[..., 0] > 128))
    pil("pil_32.bmp", Image.fromarray(np.dstack([rgb, bgr[..., 0]]), "RGBA"))
    for name in ("cv_24.bmp", "cv_8.bmp"):
        top = d / name.replace(".bmp", "_top_down.bmp")
        top.write_bytes(_top_down(out[name].read_bytes()))
        out[top.name] = top
    return out


def test_decoder_equals_cv2_imread(files):
    assert len(files) == 33
    for name, path in files.items():
        want = cv2.imread(str(path))
        assert want is not None, name
        got = image.imread(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert image.image_shape(path) == want.shape[:2] == image.read_shape(path), name
    for t in range(5):  # cv2 wrote the filter it was asked for
        raw, h, rb, _ = _png_rows(files[f"cv_filter{t}.png"])
        assert set(raw.reshape(h, rb + 1)[:, 0]) == {t}


def test_cpp_unfilter_equals_numpy(files):
    if not native.AVAILABLE:
        pytest.skip("no host C++ compiler")
    seen = set()
    for name, path in files.items():
        if name.endswith(".png"):
            raw, h, row_bytes, bpp = _png_rows(path)
            seen |= set(raw.reshape(h, row_bytes + 1)[:, 0].tolist())
            np.testing.assert_array_equal(native.png_unfilter(raw, h, row_bytes, bpp),
                                          image.unfilter_np(raw, h, row_bytes, bpp), name)
    assert seen == {0, 1, 2, 3, 4}
    bad = np.zeros(2 * 4, np.uint8)
    bad[4] = 5  # row 1: filter type 5
    with pytest.raises(ValueError, match="row 1"):
        native.png_unfilter(bad, 2, 3, 3)
    with pytest.raises(ValueError, match="row 1"):
        image.unfilter_np(bad, 2, 3, 3)


def test_other_formats_go_to_pil_or_raise(tmp_path, monkeypatch):
    bgr = np.random.default_rng(1).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    jpg = tmp_path / "a.jpg"
    cv2.imwrite(str(jpg), bgr)
    interlaced = tmp_path / "interlaced.png"
    _write_interlaced(interlaced, np.ascontiguousarray(bgr[:, :, ::-1]))
    want = {path: cv2.imread(str(path)) for path in (jpg, interlaced)}
    for path in (jpg, interlaced):
        got = image.imread(path)  # PIL
        assert got.shape == want[path].shape
        if path == interlaced:  # lossless: PIL's pixels are cv2's
            np.testing.assert_array_equal(got, want[path])
    assert image.read_shape(jpg) == (16, 24)
    monkeypatch.setattr(image, "HAVE_PIL", False)
    for path in (jpg, interlaced):
        with pytest.raises(image.NoReader, match="Without PIL.*PNG.*BMP.*sidecar"):
            image.imread(path)
    with pytest.raises(image.NoReader, match="Without PIL"):
        image.read_shape(jpg)
    assert image.read_shape(interlaced) == (16, 24)  # the header
    (tmp_path / "notes.txt").write_text("not an image")
    assert image.imread(tmp_path / "notes.txt") is None
    assert cv2.imread(str(tmp_path / "notes.txt")) is None
    assert image.read_shape(tmp_path / "notes.txt") is None


@pytest.mark.parametrize("shape", [(37, 53, 3), (200, 300, 3), (301, 517, 3), (40, 60)])
def test_resize_bicubic_within_one_level_of_cv2(shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    for rate in (0.5, 1.5, 0.7, 2.0, 1 / 3):
        want = cv2.resize(img, None, fx=rate, fy=rate, interpolation=cv2.INTER_CUBIC)
        got = augment.resize_bicubic(img, rate)
        assert got.shape == want.shape
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_draw_rboxes_strokes_are_cv2_s():
    """Boxes inside the image, labels off: every pixel either colours lies
    within one pixel of one the other colours; the label adds only
    pixels inside its text box; the colours are the JAX palette's."""
    near = np.ones((3, 3), np.uint8)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        n = 30
        rb = np.column_stack([rng.uniform(60, 340, n), rng.uniform(60, 240, n),
                              rng.uniform(3, 80, n), rng.uniform(3, 80, n),
                              rng.uniform(-1.0, 2.5, n)])
        blank = np.zeros((300, 400, 3), np.uint8)
        cls = rng.integers(0, 15, n)
        got = plots.draw_rboxes(blank, rb, classes=cls)
        ref = np.zeros((300, 400), np.uint8)
        for p in rbox_vertices_np(rb).astype(np.int32):
            cv2.polylines(ref, [p.reshape(-1, 1, 2)], True, 1, 2)
        mine = got.any(2)
        assert not (mine & ~cv2.dilate(ref, near).astype(bool)).any()
        assert not (ref.astype(bool) & ~cv2.dilate(mine.astype(np.uint8), near)
                    .astype(bool)).any()
        colours = {tuple(c) for c in got[mine].tolist()}
        assert colours <= {plots.color(int(c)) for c in cls}
        labelled = plots.draw_rboxes(blank, rb[:1], classes=cls[:1], scores=[0.5],
                                     names=[f"c{i}" for i in range(15)])
        extra = labelled.any(2) & ~plots.draw_rboxes(blank, rb[:1], classes=cls[:1]).any(2)
        p = rbox_vertices_np(rb[:1]).astype(np.int32)[0]
        x0, y0, x1, y1 = plots.text_box(f"c{cls[0]} 0.50", plots.label_origin(p))
        ys, xs = np.nonzero(extra)
        assert len(ys) > 10 and (ys >= y0).all() and (ys < y1).all()
        assert (xs >= x0).all() and (xs < x1).all()
