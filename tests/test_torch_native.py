"""The port's native host I/O (``libbicos_tpu_torch/native``) against the
JAX package's native module (libpng), cv2 and the port's own Python paths.

* ``decode_stack`` equals the JAX ``native.decode_stack`` and cv2 on 8- and
  16-bit gray and gray+alpha PNGs of every filter type (written here by a
  numpy + zlib encoder at zlib levels 0, 1 and 9) and on cv2-written ones,
  on 1 and 8 threads; mixed depths follow the first image; RGB and RGBA are
  bit-equal to the JAX module.
* It returns None for what it leaves to the per-file path (palette, 1-bit,
  interlaced, 16-bit colour, a colour-space chunk on a colour image, a size
  unlike the first image's, a corrupted IDAT CRC, a truncated stream, no
  IEND), and ``io.load_stack_pair`` then gives what the JAX ``io`` gives,
  the same exception included.
* ``write_xyz`` is byte-equal to the JAX native writer and the Python
  writer, with the same counts and messages through ``save_pointcloud``.
* The library is built into ``_build/`` and not beside its source; without
  ``g++`` or with ``BICOS_NO_NATIVE`` the layer is None and ``io`` gives
  the same results.
* ``search.search`` and ``descriptor.popcounts`` equal the JAX package's.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp
from libbicos_tpu import descriptor as jdescriptor
from libbicos_tpu import io as jio
from libbicos_tpu import native as jnative
from libbicos_tpu import search as jsearch
from libbicos_tpu.config import Consistency as JConsistency
from libbicos_tpu.config import NoDuplicates as JNoDuplicates

from libbicos_tpu_torch import descriptor as tdescriptor
from libbicos_tpu_torch import io as tio
from libbicos_tpu_torch import native
from libbicos_tpu_torch import search as tsearch
from libbicos_tpu_torch.config import Consistency, NoDuplicates


@pytest.fixture(scope="module")
def jax_native():
    if jnative.get() is None:
        pytest.skip("the JAX native module does not build here (no libpng)")
    return jnative


@pytest.fixture(scope="module")
def lib():
    assert native.get() is not None, "the port's native library must build"
    return native


# ---------------------------------------------------------------------------
# A PNG encoder: every filter type, any zlib level, extra chunks


def _filter(kind, raw, prior, bpp):
    """Filter one scanline (uint8 arrays) as PNG type ``kind``."""
    a = np.concatenate([np.zeros(bpp, np.int32), raw[:-bpp].astype(np.int32)])
    b = prior.astype(np.int32)
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if kind == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = (np.zeros_like(a), a, b, (a + b) >> 1)[kind]
    return ((raw.astype(np.int32) - pred) & 0xFF).astype(np.uint8)


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _png(img, filters=(0,), level=6, extra=(), interlace=0, depth=None,
         color=None, idat_parts=1):
    """PNG bytes of ``img`` ((H, W) or (H, W, C), uint8/uint16; C 2: gray +
    alpha, 3: RGB, 4: RGBA); ``filters`` cycled over the rows; ``extra``:
    (type, payload) chunks before IDAT; ``idat_parts``: IDAT chunks."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = depth or (16 if img.dtype == np.uint16 else 8)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch] if color is None else color
    bpp = max(1, ch * depth // 8)
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1)
    out, prior = [], np.zeros(rows.shape[1], np.uint8)
    for r in range(h):
        kind = filters[r % len(filters)]
        out.append(np.concatenate([[kind], _filter(kind, rows[r], prior,
                                                   bpp)]).astype(np.uint8))
        prior = rows[r]
    data = zlib.compress(np.concatenate(out).tobytes(), level)
    cut = np.linspace(0, len(data), idat_parts + 1).astype(int)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, interlace))
            + b"".join(_chunk(k, p) for k, p in extra)
            + b"".join(_chunk(b"IDAT", data[a:b])
                       for a, b in zip(cut[:-1], cut[1:]))
            + _chunk(b"IEND", b""))


def _images(dtype, shape, n, seed, smooth=False):
    g = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    if not smooth:
        return [g.integers(0, hi + 1, shape).astype(dtype) for _ in range(n)]
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = (np.sin(yy / 5.0) + np.cos(xx / 7.0) + 2) / 4 * hi
    return [np.clip(base[..., None] if len(shape) == 3 else base, 0, hi)
            .astype(dtype) + g.integers(0, 3, shape).astype(dtype)
            for _ in range(n)]


def _write(tmp_path, blobs, stem="i"):
    paths = []
    for i, b in enumerate(blobs):
        p = tmp_path / f"{stem}{i}.png"
        p.write_bytes(b)
        paths.append(p)
    return paths


def _cv2_gray(paths):
    return np.stack([cv2.imread(str(p), cv2.IMREAD_GRAYSCALE
                                | cv2.IMREAD_ANYDEPTH) for p in paths])


def _check_equal(lib, jax_native, paths, want=None, cv2_too=True):
    ref = jax_native.decode_stack(paths)
    assert ref is not None
    for threads in (1, 8):
        got = lib.decode_stack(paths, n_threads=threads)
        assert got is not None and got.dtype == ref.dtype
        assert got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, ref)
    if cv2_too:
        np.testing.assert_array_equal(_cv2_gray(paths), ref)
    if want is not None:
        np.testing.assert_array_equal(ref, want)


# ---------------------------------------------------------------------------
# decode_stack


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0, 3, 4)])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decode_every_filter_equals_jax_and_cv2(tmp_path, lib, jax_native,
                                                dtype, channels, filters):
    shape = (24, 40) if channels == 1 else (24, 40, 2)
    imgs = _images(dtype, shape, 4, seed=len(filters) + channels)
    imgs[1] = _images(dtype, shape, 1, seed=3, smooth=True)[0]
    want = np.stack([im if channels == 1 else im[..., 0] for im in imgs])
    for level in (0, 1, 9):
        paths = _write(tmp_path, [_png(im, filters, level, idat_parts=3)
                                  for im in imgs], stem=f"l{level}_")
        _check_equal(lib, jax_native, paths, want)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decode_cv2_written_equals_jax_and_cv2(tmp_path, lib, jax_native,
                                               dtype, smooth):
    imgs = _images(dtype, (64, 96), 6, seed=5, smooth=smooth)
    for level in (0, 1, 9):
        paths = []
        for i, im in enumerate(imgs):
            p = tmp_path / f"c{level}_{i}.png"
            assert cv2.imwrite(str(p), im, [cv2.IMWRITE_PNG_COMPRESSION,
                                            level])
            paths.append(p)
        _check_equal(lib, jax_native, paths, np.stack(imgs))
    paths = []
    for i, im in enumerate(imgs):  # cv2's default settings
        p = tmp_path / f"d{i}.png"
        assert cv2.imwrite(str(p), im)
        paths.append(p)
    _check_equal(lib, jax_native, paths, np.stack(imgs))


@pytest.mark.parametrize("first", [np.uint8, np.uint16])
def test_mixed_depths_follow_the_first_image(tmp_path, lib, jax_native,
                                             first):
    other = np.uint16 if first == np.uint8 else np.uint8
    imgs = [_images(first, (9, 13), 1, seed=1)[0],
            _images(other, (9, 13), 1, seed=2)[0],
            _images(first, (9, 13, 2), 1, seed=3)[0],
            _images(other, (9, 13, 2), 1, seed=4)[0]]
    paths = _write(tmp_path, [_png(im, (4, 1, 3)) for im in imgs])
    got = lib.decode_stack(paths)
    assert got is not None and got.dtype == first
    np.testing.assert_array_equal(got, jax_native.decode_stack(paths))


@pytest.mark.parametrize("channels", [3, 4])
def test_rgb_equals_jax_native(tmp_path, lib, jax_native, channels):
    """8-bit RGB and RGBA to gray bit for bit as libpng's
    ``png_set_rgb_to_gray_fixed(png, 1, 29900, 58700)``; cv2-written files
    too, and every filter type."""
    imgs = _images(np.uint8, (20, 33, channels), 4, seed=channels)
    imgs[0][..., 1] = imgs[0][..., 0]  # some gray pixels (r == g == b)
    imgs[0][..., 2] = imgs[0][..., 0]
    paths = _write(tmp_path, [_png(im, (f,)) for f, im in
                              zip((0, 1, 3, 4), imgs)], stem="e")
    for i, im in enumerate(imgs):
        p = tmp_path / f"cv{i}.png"
        assert cv2.imwrite(str(p), im)
        paths.append(p)
    _check_equal(lib, jax_native, paths, cv2_too=False)


def _corrupt(blob, what):
    data = bytearray(blob)
    i = data.index(b"IDAT")
    if what == "crc":
        (n,) = struct.unpack(">I", data[i - 4:i])
        data[i + 4 + n] ^= 0x01
        return bytes(data)
    if what == "truncated":  # the zlib stream cut short, CRCs still right
        (n,) = struct.unpack(">I", data[i - 4:i])
        payload = bytes(data[i + 4:i + 4 + n // 2])
        return (bytes(data[:i - 4]) + _chunk(b"IDAT", payload)
                + _chunk(b"IEND", b""))
    if what == "no IEND":
        return bytes(data[:data.index(b"IEND") - 4])
    raise ValueError(what)


NONE_CASES = ["palette", "1-bit", "interlaced", "16-bit rgb", "rgb gAMA",
              "size", "idat crc", "truncated", "no IEND", "not a png"]


def _none_case(tmp_path, case):
    """Three PNGs of which the native path refuses at least one."""
    g = np.random.default_rng(7)
    gray = [g.integers(0, 256, (8, 16), dtype=np.uint8) for _ in range(3)]
    blobs = [_png(im, (0, 4)) for im in gray]
    if case == "palette":
        pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        pal[:, 1] = 255 - pal[:, 1]
        blobs[1] = _png(gray[1], color=3, extra=[(b"PLTE", pal.tobytes())])
    elif case == "1-bit":
        bits = np.packbits(gray[1] & 1, axis=1)
        blobs[1] = _png(bits.astype(np.uint8), depth=1)
        blobs[1] = blobs[1][:16] + struct.pack(">II", 16, 8) + blobs[1][24:]
        data = bytearray(blobs[1])
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        blobs[1] = bytes(data)
    elif case == "interlaced":
        blobs[1] = _interlaced(gray[1])
    elif case == "16-bit rgb":  # the whole stack: see the test's note
        blobs = [_png(g.integers(0, 65536, (8, 16, 3)).astype(np.uint16))
                 for _ in range(3)]
    elif case == "rgb gAMA":
        blobs = [_png(g.integers(0, 256, (8, 16, 3)).astype(np.uint8),
                      extra=[(b"gAMA", struct.pack(">I", 45455))])
                 for _ in range(3)]
    elif case == "size":
        blobs[1] = _png(g.integers(0, 256, (8, 15)).astype(np.uint8))
    elif case == "idat crc":
        blobs[1] = _corrupt(blobs[1], "crc")
    elif case == "truncated":
        blobs[1] = _corrupt(blobs[1], "truncated")
    elif case == "no IEND":
        blobs[1] = _corrupt(blobs[1], "no IEND")
    elif case == "not a png":
        blobs[1] = b"GIF89a" + bytes(40)
    return blobs


def _interlaced(img):
    """An Adam7-interlaced 8-bit gray PNG of ``img``, filter None."""
    h, w = img.shape
    passes = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
              (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)]
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the exception itself is what is compared
        return "raised", (type(e), str(e))


def _same_outcome(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "raised":
        assert got[1] == want[1]
        return
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", NONE_CASES)
def test_none_cases_take_the_per_file_path(tmp_path, monkeypatch, lib,
                                           jax_native, case):
    """None from ``decode_stack``; ``load_stack_pair`` then gives what the
    JAX ``io`` gives and what the port gives with ``BICOS_NO_NATIVE``. The
    two colour cases fill the whole stack: in a stack whose first image is
    8-bit gray, the JAX native module would keep the high byte of a 16-bit
    colour image where the per-file path widens the stack to uint16."""
    blobs = _none_case(tmp_path, case)
    paths = _write(tmp_path, blobs, stem="x")
    assert lib.decode_stack(paths) is None
    folder = tmp_path / "pair"
    folder.mkdir()
    for i, b in enumerate(blobs):
        (folder / f"{i}_left.png").write_bytes(b)
        (folder / f"{i}_right.png").write_bytes(blobs[(i + 1) % 3])
    got = _outcome(lambda: tio.load_stack_pair(folder))
    _same_outcome(got, _outcome(lambda: jio.load_stack_pair(folder)))
    monkeypatch.setenv("BICOS_NO_NATIVE", "1")
    _same_outcome(got, _outcome(lambda: tio.load_stack_pair(folder)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("layout", ["two", "single"])
def test_load_stack_pair_with_and_without_native(tmp_path, monkeypatch, lib,
                                                 dtype, layout):
    imgs = _images(dtype, (16, 24), 6, seed=11)
    if layout == "two":
        f0, f1 = tmp_path / "l", tmp_path / "r"
        f0.mkdir(), f1.mkdir()
        for i in range(3):
            cv2.imwrite(str(f0 / f"{i}.png"), imgs[i])
            cv2.imwrite(str(f1 / f"{i}.png"), imgs[3 + i])
    else:
        f0, f1 = tmp_path, None
        for i in range(3):
            cv2.imwrite(str(f0 / f"{i}_left.png"), imgs[i])
            cv2.imwrite(str(f0 / f"{i}_right.png"), imgs[3 + i])
    calls = []
    real = native.decode_stack
    monkeypatch.setattr(native, "decode_stack",
                        lambda p, *a: calls.append(len(p)) or real(p, *a))
    with_native = tio.load_stack_pair(f0, f1)
    assert calls == [3, 3]
    monkeypatch.setenv("BICOS_NO_NATIVE", "1")
    assert native.get() is None
    without = tio.load_stack_pair(f0, f1)
    for a, b, c in zip(with_native, without, jio.load_stack_pair(f0, f1)):
        assert a.dtype == b.dtype == c.dtype == dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------------------------
# write_xyz


def _cloud(n=60, seed=11):
    g = np.random.default_rng(seed)
    pts = g.normal(0, 300, (n, 3)).astype(np.float32)
    pts[:8] = [[0.1, -0.0, 0.0], [1e-7, 123456789.0, 1.5e38],
               [3.0, 2.0, 1.0], [-2.5e-5, 0.3333333, 7.0],
               [np.inf, 1.0, 2.0], [1.0, -np.inf, 2.0], [4.0, 5.0, -0.0],
               [1.0, 2.0, -1e-30]]
    pts[8, 2] = np.nan
    disp = g.normal(20, 5, n).astype(np.float32)
    disp[[9, 10]] = np.nan
    return pts, disp


@pytest.mark.parametrize("allow_negative_z", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_xyz_equals_jax_native_and_python(tmp_path, lib, jax_native,
                                                dtype, allow_negative_z):
    pts, disp = _cloud()
    pts = pts.astype(dtype)
    n = lib.write_xyz(tmp_path / "p.xyz", pts, disp, allow_negative_z)
    ok = ~np.isnan(disp) & np.isfinite(pts).all(1)
    if not allow_negative_z:
        ok &= pts[:, 2] >= 0
    want = "".join("%g %g %g\n" % tuple(float(v) for v in p)
                   for p in pts[ok]).encode()
    assert n == int(ok.sum()) and (tmp_path / "p.xyz").read_bytes() == want
    m = tio._write_xyz(tmp_path / "q.xyz", pts, ok, allow_negative_z)
    assert m == n and (tmp_path / "q.xyz").read_bytes() == want
    if dtype == np.float32:
        assert jax_native.write_xyz(tmp_path / "j.xyz", pts, disp,
                                    allow_negative_z) == n
        assert (tmp_path / "j.xyz").read_bytes() == want


@pytest.mark.parametrize("threads", [1, 2, 0])
def test_write_xyz_chunks_in_order(tmp_path, lib, jax_native, threads):
    """Several 65536-point chunks over several rounds of threads (the C
    function's thread count; 0: one per core): the same bytes as the JAX
    writer."""
    g = np.random.default_rng(3)
    n = 5 * 65536 + 123
    pts = g.normal(0, 50, (n, 3)).astype(np.float32)
    disp = np.where(g.random(n) < 0.1, np.nan, 1.0).astype(np.float32)
    got = lib.get().bicos_write_xyz(
        os.fsencode(tmp_path / "t.xyz"), pts.ctypes.data, disp.ctypes.data,
        n, 0, 0, threads)
    want = jax_native.write_xyz(tmp_path / "j.xyz", pts, disp, False)
    assert got == want
    assert (tmp_path / "t.xyz").read_bytes() == (tmp_path /
                                                 "j.xyz").read_bytes()


@pytest.mark.parametrize("kind", ["float32", "int16"])
@pytest.mark.parametrize("allow_negative_z", [False, True])
def test_save_pointcloud_native_python_and_jax(tmp_path, monkeypatch, capsys,
                                               lib, kind, allow_negative_z):
    """``save_pointcloud`` writes the same bytes, count, stdout and stderr
    with the native writer, with ``BICOS_NO_NATIVE`` (its text formatted
    in chunks of 7 points) and as the JAX ``io``; int16 -32768 is skipped
    like NaN."""
    monkeypatch.setattr(tio, "_XYZ_ROWS", 7)
    if kind == "int16":
        g = np.random.default_rng(2)
        disp = g.integers(-5, 40, (6, 9)).astype(np.int16)
        disp[0, :4] = -32768
        disp[1, :2] = 0
        q = np.array([[1, 0, 0, -4.5], [0, 1, 0, -3.0], [0, 0, 0, 90.0],
                      [0, 0, 1 / 0.2, 0]])
        pts = tio.reproject_image_to_3d(disp, q)
    else:
        pts, disp = _cloud()
    outs = {}
    for name in ("native", "python", "jax"):
        if name == "python":
            monkeypatch.setenv("BICOS_NO_NATIVE", "1")
        save = jio.save_pointcloud if name == "jax" else tio.save_pointcloud
        n = save(pts, disp, tmp_path / f"{name}.xyz", allow_negative_z)
        io_text = capsys.readouterr()
        outs[name] = (n, (tmp_path / f"{name}.xyz").read_bytes(),
                      io_text.out.replace(str(tmp_path / name), "X"), io_text.err)
        monkeypatch.delenv("BICOS_NO_NATIVE", raising=False)
    assert outs["native"] == outs["python"] == outs["jax"]
    assert outs["native"][0] > 0
    assert "non-finite" in outs["native"][3]  # inf, NaN; int16: d == 0
    if kind == "int16" and not allow_negative_z:
        assert "negative Z" in outs["native"][3]


# ---------------------------------------------------------------------------
# Build and fallback


def test_library_lands_in_build_dir(lib):
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.name == "_build"
    src = native._SRC.parent
    assert not [p for p in src.iterdir() if p.suffix == ".so"]


def test_without_gxx_the_layer_is_none_and_io_works(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert native.build() is None
    assert native.get() is None
    assert not (tmp_path / "_build").exists() or not list(
        (tmp_path / "_build").glob("*.so"))
    imgs = _images(np.uint8, (8, 12), 4, seed=1)
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"{i}_left.png"), imgs[i])
        cv2.imwrite(str(tmp_path / f"{i}_right.png"), imgs[2 + i])
    left, right = tio.load_stack_pair(tmp_path)
    np.testing.assert_array_equal(left, np.stack(imgs[:2]))
    np.testing.assert_array_equal(right, np.stack(imgs[2:]))
    pts, disp = _cloud()
    assert tio.save_pointcloud(pts, disp, tmp_path / "c.xyz") > 0


def test_rebuilt_when_the_source_changes(tmp_path, monkeypatch, lib):
    src = tmp_path / "fastio.cpp"
    src.write_text(native._SRC.read_text())
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    first = native.build()
    assert first is not None and first.exists()
    src.write_text(native._SRC.read_text() + "\n// changed\n")
    second = native.library_path()
    assert second != first and not second.exists()
    assert native.build() == second and second.exists()


# ---------------------------------------------------------------------------
# The bit-plane helpers


@pytest.mark.parametrize("nbits", [5, 32, 45])
def test_popcounts_equal_jax(nbits):
    g = np.random.default_rng(nbits)
    bits = g.random((7, 11, nbits)) < 0.4
    want = np.asarray(jdescriptor.popcounts(jnp.asarray(bits)))
    got = tdescriptor.popcounts(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["nodupes", "consistency",
                                     "consistency_nodupes"])
@pytest.mark.parametrize("nbits", [13, 40])
def test_search_on_bit_planes_equals_jax(variant, nbits):
    g = np.random.default_rng(nbits)
    b0 = g.random((5, 23, nbits)) < 0.5
    shift = np.roll(b0, -3, axis=1)
    b1 = np.where(g.random(b0.shape) < 0.05, ~shift, shift)
    jv, tv = {"nodupes": (JNoDuplicates(), NoDuplicates()),
              "consistency": (JConsistency(1, False), Consistency(1, False)),
              "consistency_nodupes": (JConsistency(2, True),
                                      Consistency(2, True))}[variant]
    want = np.asarray(jsearch.search(jnp.asarray(b0), jnp.asarray(b1), jv,
                                     backend="xla"))
    got = tsearch.search(torch.from_numpy(b0), torch.from_numpy(b1), tv)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != -32768).any()
