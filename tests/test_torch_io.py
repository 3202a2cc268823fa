"""The port's image I/O (``libbicos_tpu_torch/io.py``) against the JAX
package's and against cv2.

* With cv2 (the path the port takes where it imports) every file is
  byte-equal to the JAX module's, and every loaded stack equal.
* The stdlib path, forced by setting the port's own ``_HAS_CV2`` flag to
  False, decodes cv2-written 8- and 16-bit PNGs and PNGs of every filter
  type to cv2's pixels, writes PNGs and TIFFs that cv2 decodes to the same
  pixels, values and dtype as the cv2 path's, reads the same Q and
  reprojects within rtol 1e-6 of cv2, and refuses colour and interlaced
  PNGs.
* ``.xyz`` text is ``"%g %g %g"`` on every path, byte-equal to the JAX
  package's native writer where that library loads.
"""

import struct
import zlib

import numpy as np
import pytest

import cv2
from libbicos_tpu import io as jio
from libbicos_tpu import native as jnative

from libbicos_tpu_torch import _colormaps
from libbicos_tpu_torch import io as tio

CMAPS = {"turbo": cv2.COLORMAP_TURBO, "jet": cv2.COLORMAP_JET,
         "viridis": cv2.COLORMAP_VIRIDIS}


@pytest.fixture
def stdlib(monkeypatch):
    """The port's codecs without cv2."""
    monkeypatch.setattr(tio, "_HAS_CV2", False)


@pytest.mark.parametrize("name", sorted(CMAPS))
def test_colormap_tables_equal_cv2(name):
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                             CMAPS[name])[:, 0]
    np.testing.assert_array_equal(_colormaps.table(name), want)


# ---------------------------------------------------------------------------
# PNGs of every kind, encoded here


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prior, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _encode_png(path, img, filters, interlace=0):
    """``img``: (H, W) or (H, W, C) uint8/uint16 (C: 2 gray+alpha, 3 RGB);
    ``filters``: one filter type per row (cycled)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    color = {1: 0, 2: 4, 3: 2}[ch]
    bpp = ch * depth // 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    raw, prior = b"", bytes(w * bpp)
    for r in range(h):
        line = rows[r].tobytes()
        kind = filters[r % len(filters)]
        raw += bytes([kind]) + _filter_row(kind, line, prior, bpp)
        prior = line

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  color, 0, 0, interlace))
                     + chunk(b"tEXt", b"Comment\x00made by the test")
                     + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))


def _gray(dtype, shape=(13, 17), seed=0):
    g = np.random.default_rng(seed)
    return g.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [4, 3, 2, 1, 0, 3, 4]])
def test_stdlib_decodes_every_filter_type(tmp_path, stdlib, dtype, filters):
    img = _gray(dtype, seed=len(filters))
    img[3] = img[2]  # some zero differences
    path = tmp_path / "f.png"
    _encode_png(path, img, filters)
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH)
    got = tio._imread_gray_anydepth(path)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_stdlib_drops_alpha(tmp_path, stdlib, dtype):
    img = _gray(dtype, (9, 11, 2), seed=4)
    path = tmp_path / "la.png"
    _encode_png(path, img, [0, 1, 4])
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH)
    np.testing.assert_array_equal(want, img[..., 0])
    np.testing.assert_array_equal(tio._imread_gray_anydepth(path), want)


@pytest.mark.parametrize("dtype, shape", [(np.uint8, (30, 41)),
                                          (np.uint16, (30, 41)),
                                          (np.uint8, (1, 1))])
def test_stdlib_decodes_cv2_pngs(tmp_path, stdlib, dtype, shape):
    img = _gray(dtype, shape, seed=9)
    for level in (0, 1, 9):
        path = tmp_path / f"cv{level}.png"
        assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION,
                                            level])
        got = tio._imread_gray_anydepth(path)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("case", ["rgb", "interlaced", "palette", "4bit",
                                  "not a png"])
def test_stdlib_refuses_what_it_cannot_read(tmp_path, stdlib, case):
    path = tmp_path / "x.png"
    if case == "rgb":
        _encode_png(path, _gray(np.uint8, (4, 5, 3)), [0])
    elif case == "interlaced":
        _encode_png(path, _gray(np.uint8, (4, 5)), [0], interlace=1)
    elif case in ("palette", "4bit"):
        _encode_png(path, _gray(np.uint8, (4, 5)), [0])
        data = bytearray(path.read_bytes())
        data[24:26] = b"\x08\x03" if case == "palette" else b"\x04\x00"
        ihdr = bytes(data[12:29])
        data[29:33] = struct.pack(">I", zlib.crc32(ihdr))
        path.write_bytes(bytes(data))
    else:
        path.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(IOError):
        tio._imread_gray_anydepth(path)


# ---------------------------------------------------------------------------
# Loading, both paths against the JAX module


def _folder(tmp_path, dtype, layout, n=3, shape=(6, 8)):
    imgs = [_gray(dtype, shape, seed=i) for i in range(2 * n)]
    names = [str(i) for i in (10, 2, 0, 7, 1, 3)[:n]]
    if layout == "two":
        (tmp_path / "l").mkdir()
        (tmp_path / "r").mkdir()
        for i, name in enumerate(names):
            cv2.imwrite(str(tmp_path / "l" / f"{name}.png"), imgs[i])
            cv2.imwrite(str(tmp_path / "r" / f"{name}.png"), imgs[n + i])
        return (tmp_path / "l", tmp_path / "r")
    for i, name in enumerate(names):
        cv2.imwrite(str(tmp_path / f"{name}_left.png"), imgs[i])
        cv2.imwrite(str(tmp_path / f"{name}_right.png"), imgs[n + i])
    return (tmp_path, None)


@pytest.mark.parametrize("codec", ["cv2", "stdlib"])
@pytest.mark.parametrize("stacksize", [None, 2])
@pytest.mark.parametrize("layout", ["two", "single"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_load_stack_pair_equal(tmp_path, monkeypatch, codec, stacksize,
                               layout, dtype):
    if codec == "stdlib":
        monkeypatch.setattr(tio, "_HAS_CV2", False)
    f0, f1 = _folder(tmp_path, dtype, layout)
    want = jio.load_stack_pair(f0, f1, stacksize)
    got = tio.load_stack_pair(f0, f1, stacksize)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)
    seq = tio.read_sequence(f0, f1)
    assert [i for i, _ in seq[0]] == [i for i, _ in jio.read_sequence(f0,
                                                                      f1)[0]]


@pytest.mark.parametrize("case", ["unequal", "unnumbered", "no underscore"])
def test_read_sequence_errors_equal(tmp_path, case):
    img = _gray(np.uint8, (4, 4))
    names = {"unequal": ["0_left.png", "0_right.png", "1_left.png"],
             "unnumbered": ["a_left.png", "a_right.png"],
             "no underscore": ["0left.png"]}[case]
    for name in names:
        cv2.imwrite(str(tmp_path / name), img)
    with pytest.raises(ValueError) as want:
        jio.read_sequence(tmp_path)
    with pytest.raises(ValueError) as got:
        tio.read_sequence(tmp_path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Export


def _maps():
    g = np.random.default_rng(3)
    f = g.normal(40, 20, (21, 33)).astype(np.float32)
    f[g.random(f.shape) < 0.2] = np.nan
    i16 = np.where(np.isnan(f), -32768, np.round(f)).astype(np.int16)
    corr = np.clip(g.normal(0.7, 0.3, f.shape), -1, 1).astype(np.float32)
    corr[np.isnan(f)] = np.nan
    return {"float": f, "int16": i16, "corr": corr,
            "constant": np.full((5, 6), 3.5, np.float32),
            "all invalid": np.full((5, 6), -32768, np.int16)}


MAPS = _maps()


@pytest.mark.parametrize("colormap", sorted(CMAPS))
@pytest.mark.parametrize("kind", sorted(MAPS))
def test_save_image_cv2_bytes_equal_jax(tmp_path, capsys, kind, colormap):
    (tmp_path / "j").mkdir()
    jio.save_image(MAPS[kind], tmp_path / "j" / "m.png", colormap)
    want_out = capsys.readouterr().out
    (tmp_path / "t").mkdir()
    tio.save_image(MAPS[kind], tmp_path / "t" / "m.png", colormap)
    assert capsys.readouterr().out == want_out.replace("/j/", "/t/")
    for suffix in (".png", ".tiff"):
        assert ((tmp_path / "t" / f"m{suffix}").read_bytes()
                == (tmp_path / "j" / f"m{suffix}").read_bytes())


@pytest.mark.parametrize("colormap", sorted(CMAPS))
@pytest.mark.parametrize("kind", sorted(MAPS))
def test_save_image_stdlib_decodes_like_cv2(tmp_path, monkeypatch, capsys,
                                            kind, colormap):
    (tmp_path / "c").mkdir()
    (tmp_path / "s").mkdir()
    tio.save_image(MAPS[kind], tmp_path / "c" / "m.png", colormap)
    want_out = capsys.readouterr().out
    monkeypatch.setattr(tio, "_HAS_CV2", False)
    tio.save_image(MAPS[kind], tmp_path / "s" / "m.png", colormap)
    assert capsys.readouterr().out == want_out.replace("/c/", "/s/")
    png_c, png_s = (cv2.imread(str(tmp_path / d / "m.png"),
                               cv2.IMREAD_UNCHANGED) for d in "cs")
    assert png_s.dtype == np.uint8 and png_s.shape == png_c.shape
    np.testing.assert_array_equal(png_s, png_c)
    tif_c, tif_s = (cv2.imread(str(tmp_path / d / "m.tiff"),
                               cv2.IMREAD_UNCHANGED) for d in "cs")
    assert tif_s.dtype == tif_c.dtype
    assert tif_s.dtype == (np.int16 if MAPS[kind].dtype == np.int16
                           else np.float32)
    np.testing.assert_array_equal(tif_s, tif_c)  # NaN == NaN here
    np.testing.assert_array_equal(tif_s, MAPS[kind])


def _write_q(path, q):
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_WRITE)
    fs.write("Q", q)
    fs.release()


@pytest.mark.parametrize("q", [
    np.arange(16, dtype=np.float64).reshape(4, 4),
    np.array([[1, 0, 0, -1620.1234567891], [0, 1, 0, -1100.5],
              [0, 0, 0, 2.4e3], [0, 0, 1 / 0.123, 1e-17]]),
    np.array([[1, 0, 0, -np.inf], [0, np.nan, 0, 2], [0, 0, 0, 5],
              [0, 0, 3, 0]]),
])
def test_read_q_matrix_stdlib_equals_cv2(tmp_path, stdlib, q):
    path = tmp_path / "Q.yaml"
    _write_q(path, q)
    want = jio.read_q_matrix(path)
    got = tio.read_q_matrix(path)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, q)


def test_read_q_matrix_without_q(tmp_path, monkeypatch):
    path = tmp_path / "other.yaml"
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_WRITE)
    fs.write("R", np.eye(3))
    fs.release()
    with pytest.raises(ValueError) as want:
        jio.read_q_matrix(path)
    for flag in (True, False):
        monkeypatch.setattr(tio, "_HAS_CV2", flag)
        with pytest.raises(ValueError) as got:
            tio.read_q_matrix(path)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["float", "int16"])
def test_reproject_stdlib_near_cv2(monkeypatch, kind):
    q = np.array([[1, 0, 0, -16.5], [0, 1, 0, -10.25], [0, 0, 0, 420.0],
                  [0, 0, 1 / 0.12, 0.3]])
    disp = MAPS[kind]
    want = jio.reproject_image_to_3d(disp, q)
    np.testing.assert_array_equal(tio.reproject_image_to_3d(disp, q), want)
    monkeypatch.setattr(tio, "_HAS_CV2", False)
    got = tio.reproject_image_to_3d(disp, q)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=1e-6)


def _cloud():
    g = np.random.default_rng(11)
    pts = g.normal(0, 300, (40, 3)).astype(np.float32)
    pts[:5] = [[0.1, -0.0, 0.0], [1e-7, 123456789.0, 1.5e38],
               [3.0, 2.0, 1.0], [-2.5e-5, 0.3333333, 7.0],
               [np.inf, 1.0, 2.0]]
    pts[5, 2] = np.nan
    disp = g.normal(20, 5, 40).astype(np.float32)
    disp[[6, 7]] = np.nan
    return pts, disp


@pytest.mark.parametrize("allow_negative_z", [False, True])
@pytest.mark.parametrize("codec", ["cv2", "stdlib"])
def test_save_pointcloud_text_and_messages(tmp_path, monkeypatch, capsys,
                                           allow_negative_z, codec):
    """Byte-equal to the JAX native writer, the same count and the same
    stdout/stderr lines, and every line ``"%g %g %g"`` of a kept point."""
    if codec == "stdlib":
        monkeypatch.setattr(tio, "_HAS_CV2", False)
    pts, disp = _cloud()
    n = tio.save_pointcloud(pts, disp, tmp_path / "t.xyz", allow_negative_z)
    got_io = capsys.readouterr()
    text = (tmp_path / "t.xyz").read_bytes()
    ok = np.isfinite(disp) & np.isfinite(pts).all(1)
    if not allow_negative_z:
        ok &= pts[:, 2] >= 0
    want = "".join("%g %g %g\n" % tuple(float(v) for v in p)
                   for p in pts[ok]).encode()
    assert text == want and n == int(ok.sum())
    if jnative.get() is not None:
        assert jnative.write_xyz(tmp_path / "n.xyz", pts, disp,
                                 allow_negative_z) == n
        assert (tmp_path / "n.xyz").read_bytes() == text
    m = jio.save_pointcloud(pts, disp, tmp_path / "t.xyz", allow_negative_z)
    want_io = capsys.readouterr()
    assert m == n and (got_io.out, got_io.err) == (want_io.out,
                                                  want_io.err)
    assert "non-finite" in got_io.err


def test_save_pointcloud_int16_and_chunks(tmp_path, monkeypatch):
    """An int16 disparity's -32768 is skipped; a cloud spanning several
    formatting chunks gives the same text."""
    monkeypatch.setattr(tio, "_XYZ_ROWS", 7)
    g = np.random.default_rng(2)
    disp = g.integers(-5, 40, (6, 9)).astype(np.int16)
    disp[0, :4] = -32768
    q = np.array([[1, 0, 0, -4.5], [0, 1, 0, -3.0], [0, 0, 0, 90.0],
                  [0, 0, 1 / 0.2, 0]])
    pts = tio.reproject_image_to_3d(disp, q)
    n = tio.save_pointcloud(pts, disp, tmp_path / "c.xyz")
    jio.save_pointcloud(pts, disp, tmp_path / "j.xyz")
    assert (tmp_path / "c.xyz").read_bytes() == (tmp_path /
                                                 "j.xyz").read_bytes()
    assert n == len((tmp_path / "c.xyz").read_text().splitlines()) > 7
