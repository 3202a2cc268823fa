"""Image-stack I/O, result export and point-cloud reprojection.

The counterpart of ``libbicos_tpu.io`` (the reference's
``fileutils.cpp``), with the same layouts, messages and skip rules:

* :func:`read_sequence`: numbered two-folder (``0.png``, ``1.png``, ...)
  or single-folder (``0_left.png`` / ``0_right.png``) loading, grayscale
  at any depth, alpha dropped;
* :func:`sort_sequence_to_stack`, :func:`load_stack_pair`;
* :func:`distribute_stack`, :func:`load_multihost_stack`: only this
  process's row bands on its device (``sharding.RowBands``);
* :func:`save_image`: a colorized PNG (invalid pixels black) and the raw
  values as a TIFF, int16 staying int16 and anything else float32;
* :func:`read_q_matrix`, :func:`reproject_image_to_3d`,
  :func:`save_pointcloud` (ascii ``.xyz``, ``"%g %g %g"`` lines as the
  reference's ``operator<<`` writes them);
* :func:`synthetic_stack_pair`: the same generator as the JAX package's.

Codecs: cv2 where it imports, which then writes the same bytes as the JAX
module. Without it, a stdlib path (``zlib``, ``struct``, numpy) limited to
what the CLI reads and writes: 8- and 16-bit grayscale PNGs with or
without alpha (non-interlaced, every filter type; None, Sub and Up rows
are vectorised, Average and Paeth rows decoded by a Python loop over the
row's bytes, 0.2 and 0.4 s per megabyte of such rows on one Xeon core),
colorized PNGs from the colour tables in
``_colormaps.py``, uncompressed baseline TIFFs, the ``!!opencv-matrix``
YAML that ``cv::FileStorage`` writes, and the reprojection in numpy. It
raises on a colour, palette, low-depth or interlaced PNG rather than
return wrong pixels.

The native layer (:mod:`libbicos_tpu_torch.native`) comes first, as in
the JAX module: a folder of PNGs is decoded at once on a pool of threads
into one stack, and ``.xyz`` files are written by its C++ writer. Where it
returns None (no ``g++``, ``BICOS_NO_NATIVE`` set, or a PNG it leaves to
the codecs above) the per-file path and the Python writer run, with the
same results.
"""

from __future__ import annotations

import re
import struct
import sys
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

from . import native

INVALID_DISP_INT16 = np.int16(-32768)

# ---------------------------------------------------------------------------
# PNG and TIFF without cv2

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunks(data: bytes, path):
    """``(type, payload)`` of each chunk, CRCs checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise IOError(f"could not read image: {path} (not a PNG)")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise IOError(f"could not read image: {path} (corrupt chunk "
                          f"{kind!r})")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise IOError(f"could not read image: {path} (truncated)")


def _unfilter_loop(kind: int, raw: bytes, prior: bytes, bpp: int) -> bytes:
    """One Average (3) or Paeth (4) row, byte by byte."""
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return bytes(out)


def _png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """``(h, 1 + stride)`` filtered scanlines -> ``(h, stride)`` bytes."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.uint8)
    for r in range(h):
        kind = int(raw[r, 0])
        line = raw[r, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_loop(
                kind, line.tobytes(), prior.tobytes(), bpp), dtype=np.uint8)
        else:
            raise IOError(f"bad PNG filter type {kind} in row {r}")
        out[r] = cur
        prior = out[r]
    return out


def _png_read(path: Path) -> np.ndarray:
    """An 8- or 16-bit grayscale PNG (alpha dropped) as uint8 / uint16."""
    data = path.read_bytes()
    ihdr, idat = None, []
    for kind, payload in _png_chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if ihdr is None:
        raise IOError(f"could not read image: {path} (no IHDR)")
    w, h, depth, color, _, _, interlace = ihdr
    if color not in (0, 4) or depth not in (8, 16):
        raise IOError(
            f"{path}: only 8- and 16-bit grayscale PNGs are read without "
            f"cv2 (colour type {color}, bit depth {depth}); install "
            "opencv-python for other PNGs")
    if interlace:
        raise IOError(f"{path}: interlaced PNGs are not read without cv2; "
                      "install opencv-python")
    channels = 2 if color == 4 else 1
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise IOError(f"could not read image: {path} (bad image data size)")
    rows = _png_unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        px = rows.view(">u2").reshape(h, w, channels)[..., 0]
        return px.astype(np.uint16)
    return np.ascontiguousarray(rows.reshape(h, w, channels)[..., 0])


def _png_write(path: Path, image: np.ndarray) -> None:
    """An 8-bit RGB PNG of an ``(H, W, 3)`` array, filter None."""
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image, dtype=np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    path.write_bytes(
        _PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
        + chunk(b"IEND", b""))


def _tiff_write(path: Path, image: np.ndarray) -> None:
    """An uncompressed baseline TIFF, one strip, little-endian: int16
    (SampleFormat 2) or float32 (SampleFormat 3)."""
    image = np.ascontiguousarray(image)
    h, w = image.shape
    bits, fmt = {np.dtype(np.int16): (16, 2),
                 np.dtype(np.float32): (32, 3)}[image.dtype]
    offset = 8 + 2 + 12 * 11 + 4  # the pixels follow the header and IFD
    tags = [  # (tag, type: 3 SHORT / 4 LONG, value), in tag order
        (256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, 1),
        (262, 3, 1), (273, 4, offset), (277, 3, 1), (278, 4, h),
        (279, 4, image.nbytes), (284, 3, 1), (339, 3, fmt),
    ]
    ifd = struct.pack("<H", len(tags))
    for tag, typ, value in tags:
        packed = (struct.pack("<HH", value, 0) if typ == 3
                  else struct.pack("<I", value))
        ifd += struct.pack("<HHI", tag, typ, 1) + packed
    ifd += struct.pack("<I", 0)
    path.write_bytes(b"II*\x00" + struct.pack("<I", 8) + ifd
                     + image.astype(image.dtype.newbyteorder("<"),
                                    copy=False).tobytes())


# ---------------------------------------------------------------------------
# Loading


def _imread_gray_anydepth(path: Path) -> np.ndarray:
    if _HAS_CV2:
        m = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH)
        if m is None:
            raise IOError(f"could not read image: {path}")
        if m.ndim == 3:
            m = cv2.cvtColor(m, cv2.COLOR_BGR2GRAY)
        return m
    return _png_read(path)


_NUM_RE = re.compile(r"^(\d+)")


def _leading_index(fname: str) -> int:
    m = _NUM_RE.match(fname)
    if not m:
        raise ValueError(
            "Expecting numbered files with names NN.png; e.g 0.png, 1.png..."
        )
    return int(m.group(1))


def _decode_seq(entries: List[Tuple[int, Path]]
                ) -> List[Tuple[int, np.ndarray]]:
    """Decode ``(index, path)`` entries: all PNGs at once on the native
    threaded decoder (``native.decode_stack``) where it takes them, else
    file by file."""
    if entries and all(str(p).lower().endswith(".png") for _, p in entries):
        stack = native.decode_stack([p for _, p in entries])
        if stack is not None:
            return [(idx, stack[i]) for i, (idx, _) in enumerate(entries)]
    return [(idx, _imread_gray_anydepth(p)) for idx, p in entries]


def read_sequence(
    folder0,
    folder1=None,
) -> Tuple[List[Tuple[int, np.ndarray]], List[Tuple[int, np.ndarray]]]:
    """Load ``(index, image)`` sequences like the reference: the two-folder
    layout uses ``N.png`` in each folder, the single-folder layout
    ``N_left.png`` / ``N_right.png``."""
    folder0 = Path(folder0)
    lpaths: List[Tuple[int, Path]] = []
    rpaths: List[Tuple[int, Path]] = []
    if folder1 is not None:
        for seq, d in ((lpaths, folder0), (rpaths, Path(folder1))):
            for p in sorted(Path(d).iterdir()):
                if not p.is_file():
                    continue
                seq.append((_leading_index(p.name), p))
    else:
        for p in sorted(folder0.iterdir()):
            if not p.is_file():
                continue
            name = p.name
            if "_" not in name:
                raise ValueError(
                    "Expecting numbered files with names NN_{left,right}.png;"
                    " e.g.: 5_left.png, 10_right.png..."
                )
            idx = _leading_index(name)
            (lpaths if "_left" in name else rpaths).append((idx, p))
    if len(lpaths) != len(rpaths):
        raise ValueError(
            f"Unequal number of images; left: {len(lpaths)}, "
            f"right: {len(rpaths)}"
        )
    return _decode_seq(lpaths), _decode_seq(rpaths)


def sort_sequence_to_stack(
    lseq: Sequence[Tuple[int, np.ndarray]],
    rseq: Sequence[Tuple[int, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by numeric index and stack to ``(n, H, W)`` arrays."""
    ls = [img for _, img in sorted(lseq, key=lambda e: e[0])]
    rs = [img for _, img in sorted(rseq, key=lambda e: e[0])]
    return np.stack(ls), np.stack(rs)


def load_stack_pair(folder0, folder1=None, stacksize: Optional[int] = None):
    """Read, sort and optionally truncate to ``stacksize`` images."""
    lseq, rseq = read_sequence(folder0, folder1)
    l, r = sort_sequence_to_stack(lseq, rseq)
    if stacksize is not None and stacksize < l.shape[0]:
        l, r = l[:stacksize], r[:stacksize]
    return l, r


def distribute_stack(stack, *, mesh):
    """The row bands of a full host ``(n, H, W)`` stack (identical on every
    process) that this process holds on ``mesh``: a
    :class:`sharding.RowBands`, whose bands alone go to ``mesh.device``,
    cut and zero-padded as ``sharding.match_sharded`` cuts a full stack. A
    ``(batch, n, H, W)`` stack is folded into ``(n, batch*H, W)`` on the
    host first, for ``sharding.match_batched_sharded``.

    The counterpart of ``libbicos_tpu.io.distribute_stack``, which returns
    one global row-sharded ``jax.Array``; the sharded entry points here
    take the ``RowBands`` in place of the full stack."""
    from .sharding import fold_host, row_bands

    stack = np.asarray(stack)
    if stack.ndim == 4:
        return row_bands(fold_host(stack), mesh, batch=stack.shape[0])
    return row_bands(stack, mesh)


def load_multihost_stack(folder0, folder1=None, *, mesh, stacksize=None):
    """Per-process sharded stack loading: every process reads the full
    files (images are small) but puts only its own row bands on its device
    (see :func:`distribute_stack`)."""
    l, r = load_stack_pair(folder0, folder1, stacksize)
    return distribute_stack(l, mesh=mesh), distribute_stack(r, mesh=mesh)


# ---------------------------------------------------------------------------
# Result export


def _invalid_mask(image: np.ndarray) -> np.ndarray:
    if np.issubdtype(image.dtype, np.floating):
        return ~np.isfinite(image)
    return image == INVALID_DISP_INT16


def save_image(image, outfile, colormap: str = "turbo") -> None:
    """Save a disparity or correlation map as a colorized PNG (``turbo``,
    ``jet`` or ``viridis``; invalid pixels black) and the raw values as a
    TIFF in the image's own dtype when it is int16, else float32.
    ``outfile``'s extension is replaced per format, as the reference
    does."""
    image = np.asarray(image)
    outfile = Path(outfile)
    mask = _invalid_mask(image)
    vals = image.astype(np.float32)
    finite = vals[~mask]
    if finite.size:
        lo, hi = float(finite.min()), float(finite.max())
    else:
        lo, hi = 0.0, 1.0
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    # cv::normalize quantizes with a rounding saturate_cast (half to even):
    # np.rint matches it, so the colorized PNG is byte-identical.
    shifted = np.where(mask, 0.0, (vals - lo) * scale)
    norm = np.clip(np.rint(shifted), 0, 255).astype(np.uint8)
    norm[mask] = 0
    png = outfile.with_suffix(".png")
    tiff = outfile.with_suffix(".tiff")
    raw = image if image.dtype == np.int16 else vals
    if _HAS_CV2:
        cmap = {"turbo": cv2.COLORMAP_TURBO, "jet": cv2.COLORMAP_JET,
                "viridis": cv2.COLORMAP_VIRIDIS}[colormap]
        colorized = cv2.applyColorMap(norm, cmap)
        colorized[mask] = 0
        if cv2.imwrite(str(png), colorized):
            print(f"Saved colorized disparity to\t\t{png}")
        if cv2.imwrite(str(tiff), raw):
            print(f"Saved floating-point disparity to\t{tiff}")
        return
    from ._colormaps import table

    colorized = table(colormap)[norm]
    colorized[mask] = 0
    _png_write(png, colorized[..., ::-1])  # BGR tables, RGB in the file
    print(f"Saved colorized disparity to\t\t{png}")
    _tiff_write(tiff, raw)
    print(f"Saved floating-point disparity to\t{tiff}")


_YAML_SPECIAL = {".inf": np.inf, "+.inf": np.inf, "-.inf": -np.inf,
                 ".nan": np.nan}


def _read_q_yaml(path: Path) -> np.ndarray:
    """Matrix ``Q`` of a ``cv::FileStorage`` YAML file."""
    text = path.read_text()
    m = re.search(r"^Q:[ \t]*!!opencv-matrix[ \t]*\n((?:[ \t]+.*(?:\n|$))*)",
                  text, re.M)
    if not m:
        raise ValueError(f"no matrix 'Q' in {path}")
    body = m.group(1)
    rows = re.search(r"\brows:\s*(\d+)", body)
    cols = re.search(r"\bcols:\s*(\d+)", body)
    data = re.search(r"\bdata:\s*\[(.*?)\]", body, re.S)
    if not (rows and cols and data):
        raise ValueError(f"no matrix 'Q' in {path}")
    vals = [_YAML_SPECIAL.get(t.lower()) if t.lower() in _YAML_SPECIAL
            else float(t) for t in re.split(r"[\s,]+", data.group(1).strip())
            if t]
    shape = (int(rows.group(1)), int(cols.group(1)))
    if len(vals) != shape[0] * shape[1]:
        raise ValueError(f"matrix 'Q' in {path}: {len(vals)} values for "
                         f"{shape[0]} x {shape[1]}")
    return np.asarray(vals, dtype=np.float64).reshape(shape)


def read_q_matrix(path) -> np.ndarray:
    """The 4x4 reprojection matrix ``Q`` of a ``cv::FileStorage`` YAML
    file, float64."""
    if _HAS_CV2:
        fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
        try:
            q = fs.getNode("Q").mat()
        finally:
            fs.release()
        if q is None:
            raise ValueError(f"no matrix 'Q' in {path}")
        return np.asarray(q, dtype=np.float64)
    return _read_q_yaml(Path(path))


def reproject_image_to_3d(disparity, q: np.ndarray) -> np.ndarray:
    """``cv::reprojectImageTo3D``: an ``(H, W)`` disparity and a 4x4 ``Q``
    -> ``(H, W, 3)`` float32 points; invalid disparities give non-finite
    or far points, which :func:`save_pointcloud` skips."""
    disparity = np.asarray(disparity, dtype=np.float32)
    if _HAS_CV2:
        return cv2.reprojectImageTo3D(disparity, q.astype(np.float64))
    h, w = disparity.shape
    ys, xs = np.mgrid[0:h, 0:w]
    vec = np.stack([xs, ys, disparity, np.ones_like(disparity)], axis=-1)
    out = vec @ np.asarray(q, dtype=np.float64).T
    with np.errstate(divide="ignore", invalid="ignore"):
        return (out[..., :3] / out[..., 3:4]).astype(np.float32)


_XYZ_ROWS = 1 << 16  # points formatted by one % operation


def save_pointcloud(points, disparity, outfile,
                    allow_negative_z: bool = False) -> int:
    """Ascii ``.xyz`` export: one ``"%g %g %g"`` line a point, skipping
    invalid disparities and non-finite points silently and negative Z
    (``z == 0`` kept) unless ``allow_negative_z``, then reporting the
    non-finite and negative-Z points among the valid pixels on stderr.
    Returns the number of points written."""
    points = np.asarray(points).reshape(-1, 3)
    disp = np.asarray(disparity).reshape(-1)
    outfile = Path(outfile).with_suffix(".xyz")
    valid = ~_invalid_mask(disp)
    finite = np.isfinite(points).all(axis=1)
    # The native writer first, with every invalid disparity folded into NaN.
    dispf = disp.astype(np.float32)
    dispf[~valid] = np.nan
    n = native.write_xyz(outfile, points, dispf, allow_negative_z)
    if n is None:
        n = _write_xyz(outfile, points, valid & finite, allow_negative_z)
    n_nonfinite = int((valid & ~finite).sum())
    n_negative_z = 0
    if not allow_negative_z:
        n_negative_z = int((valid & finite & (points[:, 2] < 0)).sum())
    print(f"Saved pointcloud in ascii-format to\t{outfile}")
    if n_nonfinite:
        print(f"Skipped {n_nonfinite} points with non-finite fp values",
              file=sys.stderr)
    if n_negative_z:
        print(f"Skipped {n_negative_z} points with negative Z values",
              file=sys.stderr)
    return n


def _write_xyz(outfile: Path, points: np.ndarray, ok: np.ndarray,
               allow_negative_z: bool) -> int:
    """The ``.xyz`` text without the native writer: the points where ``ok``
    and, unless ``allow_negative_z``, ``z >= 0``. Returns their number."""
    if not allow_negative_z:
        ok = ok & (points[:, 2] >= 0)
    kept = points[ok].astype(np.float64)
    with open(outfile, "w") as f:
        for i in range(0, kept.shape[0], _XYZ_ROWS):
            part = kept[i:i + _XYZ_ROWS]
            f.write(("%g %g %g\n" * part.shape[0]) % tuple(part.ravel()
                                                           .tolist()))
    return int(kept.shape[0])


# ---------------------------------------------------------------------------
# Synthetic data


def synthetic_stack_pair(
    n: int,
    height: int,
    width: int,
    dtype=np.uint8,
    max_disp: Optional[int] = None,
    seed: int = 0x600DF00D,  # the reference bench seed
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Projected-pattern stereo simulator: a random per-shot pattern warped
    by a smooth disparity field. Returns (stack0, stack1, true_disparity);
    the same seed gives the same stacks as
    ``libbicos_tpu.io.synthetic_stack_pair``."""
    rng = np.random.default_rng(seed)
    if max_disp is None:
        max_disp = max(4, width // 16)
    hi = np.iinfo(dtype).max
    wide = width + max_disp
    pattern = rng.integers(0, hi + 1, size=(n, height, wide)).astype(dtype)
    # Smooth integer disparity field (>= 1) on LEFT pixel coordinates.
    yy = np.linspace(0, np.pi * 2, height)[:, None]
    xx = np.linspace(0, np.pi * 3, width)[None, :]
    field = (np.sin(yy) * np.cos(xx) + 1) / 2  # [0, 1]
    disp = (1 + field * (max_disp - 1)).astype(np.int32)
    cols = np.arange(width)[None, :]
    # right[c] = pattern[c + max_disp]; left[c] = pattern[c + max_disp - d]
    # => left[col0] == right[col0 - d]: disparity d = col0 - col1 > 0.
    right = pattern[:, :, max_disp : max_disp + width]
    src = cols + max_disp - disp
    left = np.take_along_axis(
        pattern, np.broadcast_to(src, (n, height, width)), axis=2
    )
    return (
        np.ascontiguousarray(left),
        np.ascontiguousarray(right),
        disp.astype(np.int16),
    )
