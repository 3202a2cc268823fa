"""Scale-out: the pipeline over row bands (H-band) or column bands (W-band).

The counterpart of ``libbicos_tpu.sharding``:

* **H-banding** (:func:`match_sharded`, :func:`match_batched_sharded`):
  every stage is row-independent (epipolar geometry), so each band runs
  :func:`pipeline.match` on its rows and only the results are gathered.
* **W-banding** (:func:`match_sharded_w`, :func:`row_minima_wband`): for
  very wide rows each band holds a column band of left descriptors and the
  right descriptor bands travel a ring; each visit folds into running packed
  ``cost * PACK_K + col`` minima (``kernels/band.py``), so the reduction
  across bands is a plain elementwise minimum and NoDuplicates ties keep
  first-occurrence order exactly. Consistency runs the same one ring with
  the fused step, which also folds every visit's pairs into the reverse
  minima of the right columns (indexed by the global column, one
  accumulator per process, minimum-reduced across the mesh by
  ``mesh.reduce_min``). Visits that no pair of a bounded disparity range
  can reach are skipped (:func:`wband_ring_visits`).

A mesh (:func:`make_mesh`) is one of two transports behind one interface:

* :class:`DistMesh`: one band per process of ``torch.distributed``'s default
  group (gloo on the CPU, NCCL on cards); the ring moves bands with
  ``batch_isend_irecv``.
* :class:`LocalMesh` (``make_mesh(n, virtual=True, device=...)``): ``n``
  bands held by this process on one device; the ring rotates a list. It is
  how one card runs the sharded paths, as the JAX suite runs them on a
  virtual CPU mesh.

A mesh's ``device`` is where its bands run. ``None`` (the default) means the
current CUDA device, and raises without a card: pass ``device="cpu"`` for
the CPU (gloo workers included).

Every process passes the full stacks, or only the row bands that it holds
(:class:`RowBands`, from ``io.distribute_stack`` or :func:`row_bands`), and
gets the full ``(H, W)`` maps back on every rank. The JAX surfaces take and
return one global ``jax.Array`` whose shards stay on their devices; here
each rank gathers the whole result (``mesh.all_gather``), which is what a
caller of the JAX surface gets when it reads the array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import pipeline as _pipeline
from . import search as _search
from .config import BIG, PACK_K, Config, NoDuplicates
from .kernels.band import row_minima_band, row_minima_consistency_band


class LocalMesh:
    """``size`` bands held by this process on ``device`` (None: the current
    CUDA device); ``shift``, ``all_gather`` and ``reduce_min`` move no data
    between processes."""

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError(f"a mesh needs at least one band, got {size}")
        self.size = size
        self.ranks = tuple(range(size))
        self.device = _pipeline.resolve_device(device)

    def shift(self, payloads: List[torch.Tensor], k: int):
        """Band ``r`` receives band ``(r + k) % size``'s payload."""
        k %= self.size
        return payloads[k:] + payloads[:k]

    def all_gather(self, tensors: Sequence[torch.Tensor], dim: int):
        """Every band's tensor, in band order, concatenated along ``dim``."""
        return torch.cat(list(tensors), dim)

    def reduce_min(self, tensor: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum over the processes' ``tensor``: every
        held band folds into this process's one tensor, so it is that
        tensor."""
        return tensor


class DistMesh:
    """One band per process of the default ``torch.distributed`` group, on
    ``device`` (None: the current CUDA device); this process plays rank
    ``dist.get_rank()``."""

    def __init__(self, device=None):
        import torch.distributed as dist

        self._dist = dist
        self.size = dist.get_world_size()
        self.ranks = (dist.get_rank(),)
        self.device = _pipeline.resolve_device(device)

    def shift(self, payloads: List[torch.Tensor], k: int):
        """This rank receives rank ``(r + k) % size``'s payload and sends
        its own to rank ``(r - k) % size`` (the JAX ``ppermute`` with
        ``perm=[((d + k) % n, d)]``)."""
        k %= self.size
        if k == 0:
            return payloads
        dist = self._dist
        (x,) = payloads
        (r,) = self.ranks
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (r - k) % self.size),
               dist.P2POp(dist.irecv, out, (r + k) % self.size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [out]

    def all_gather(self, tensors: Sequence[torch.Tensor], dim: int):
        """Every rank's tensor, in rank order, concatenated along ``dim``.
        int16 travels as int32 (neither gloo nor NCCL moves it)."""
        (x,) = tensors
        wire = (x.to(torch.int32) if x.dtype == torch.int16
                else x.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        self._dist.all_gather(parts, wire)
        return torch.cat(parts, dim).to(x.dtype)

    def reduce_min(self, tensor: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum over every rank's ``tensor`` (int32 or
        wider; gloo and NCCL both take MIN), in place."""
        self._dist.all_reduce(tensor, op=self._dist.ReduceOp.MIN)
        return tensor


def make_mesh(n_devices: Optional[int] = None, *, virtual: bool = False,
              device=None):
    """A 1-D mesh of ``n_devices`` bands.

    ``virtual=True``: a :class:`LocalMesh` of ``n_devices`` bands on
    ``device``. Otherwise, with ``torch.distributed`` initialised, a
    :class:`DistMesh` over the default group (``n_devices`` defaults to, and
    must equal, its world size); without it, only one band. ``device=None``
    is the current CUDA device (it raises without a card); pass ``"cpu"``
    for the CPU."""
    if virtual:
        if n_devices is None:
            raise ValueError("a virtual mesh needs n_devices")
        return LocalMesh(n_devices, device)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            # Another count would attribute results to bands never used.
            raise ValueError(f"requested {n_devices} devices but the "
                             f"process group has {world}")
        return DistMesh(device)
    if n_devices not in (None, 1):
        raise ValueError(
            f"requested {n_devices} devices without torch.distributed "
            "initialised; pass virtual=True for bands on one device")
    return LocalMesh(1, device)


def _bands(x: torch.Tensor, dim: int, mesh) -> List[torch.Tensor]:
    """``x`` zero-padded along ``dim`` to a multiple of ``mesh.size`` and
    cut into equal bands: the bands this process holds, contiguous."""
    pad = (-x.shape[dim]) % mesh.size
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    parts = x.chunk(mesh.size, dim)
    return [parts[r].contiguous() for r in mesh.ranks]


@dataclass(frozen=True)
class RowBands:
    """The row bands of one stack that this process holds on its mesh's
    device: ``bands[j]`` is band ``mesh.ranks[j]`` of ``mesh.size``, an
    ``(n, ceil(H / size), W)`` tensor cut and zero-padded as :func:`_bands`
    cuts the full stack. ``shape`` is the full ``(n, H, W)``; ``batch`` is
    the number of ``(n, H / batch, W)`` pairs folded into its rows (0 for a
    plain stack)."""

    bands: tuple
    shape: tuple
    batch: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return self.bands[0].dtype


def host_band(stack: np.ndarray, rank: int, size: int) -> np.ndarray:
    """Row band ``rank`` of ``size`` of a host ``(n, H, W)`` array, zero
    padded at the bottom as :func:`_bands` pads: a new array."""
    n, h, w = stack.shape
    band = -(-h // size)
    part = stack[:, rank * band:(rank + 1) * band]
    out = np.zeros((n, band, w), stack.dtype)
    out[:, :part.shape[1]] = part
    return out


def row_bands(stack: np.ndarray, mesh, batch: int = 0) -> RowBands:
    """The :class:`RowBands` of a full host ``(n, H, W)`` stack for
    ``mesh``: only this process's bands are cut, and only they are moved
    to ``mesh.device``. ``batch``: pairs folded into the rows
    (:func:`fold_host`)."""
    if stack.ndim != 3:
        raise ValueError("stacks must have shape (n, H, W)")
    bands = [torch.from_numpy(host_band(stack, r, mesh.size)).to(
        mesh.device) for r in mesh.ranks]
    return RowBands(tuple(bands), tuple(stack.shape), batch)


def fold_host(stacks: np.ndarray) -> np.ndarray:
    """``(batch, n, H, W)`` folded into ``(n, batch*H, W)`` on the host, as
    :func:`pipeline._fold_batch` folds on the device."""
    b, n, h, w = stacks.shape
    return np.ascontiguousarray(
        np.moveaxis(np.asarray(stacks), 0, 1)).reshape(n, b * h, w)


def _prepare_bands(stack0, stack1, cfg: Config, corrmap: bool, backend: str,
                   mesh):
    """``_pipeline._prepare`` for :class:`RowBands`: the same checks on the
    full shapes, then ``(bands0, bands1, resolved backend)`` on the mesh's
    device."""
    if backend not in _search.BACKENDS:
        raise ValueError(
            f"backend must be one of {_search.BACKENDS}, got {backend!r}")
    if not (isinstance(stack0, RowBands) and isinstance(stack1, RowBands)):
        raise ValueError("pass both stacks as RowBands, or neither")
    _pipeline.check_stacks(stack0.shape, stack1.shape, stack0.dtype,
                           stack1.dtype, cfg, corrmap)
    if stack0.batch != stack1.batch:
        raise ValueError(f"batch {stack0.batch} vs {stack1.batch}")
    n, h, w = stack0.shape
    want = (n, -(-h // mesh.size), w)
    for s in (stack0, stack1):
        if (len(s.bands) != len(mesh.ranks)
                or any(tuple(b.shape) != want for b in s.bands)):
            raise ValueError(
                f"the row bands were not cut for this mesh: want "
                f"{len(mesh.ranks)} bands of {want}")
    bands0 = [b.to(mesh.device) for b in stack0.bands]
    bands1 = [b.to(mesh.device) for b in stack1.bands]
    return bands0, bands1, _search.resolve_backend(backend, *bands0,
                                                   *bands1)


def match_sharded(stack0, stack1, cfg: Config = Config(), *, mesh=None,
                  corrmap: bool = False, backend: str = "auto"):
    """H-banded ``match``: rows cut into ``mesh.size`` bands, each matched
    by :func:`pipeline.match`, the results gathered. Same arguments and
    results as ``match``, plus ``mesh`` (default :func:`make_mesh`); the
    stacks may also be this process's :class:`RowBands`."""
    mesh = make_mesh() if mesh is None else mesh
    if isinstance(stack0, RowBands) or isinstance(stack1, RowBands):
        bands0, bands1, backend = _prepare_bands(stack0, stack1, cfg,
                                                 corrmap, backend, mesh)
    else:
        stack0, stack1, backend = _pipeline._prepare(
            stack0, stack1, cfg, corrmap, backend, mesh.device)
        bands0, bands1 = _bands(stack0, 1, mesh), _bands(stack1, 1, mesh)
    h = stack0.shape[1]
    outs = []
    for b0, b1 in zip(bands0, bands1):
        out = _pipeline.match(b0, b1, cfg, corrmap=corrmap, backend=backend,
                              device=b0.device)
        outs.append(out if corrmap else (out, None))
    disp = mesh.all_gather([d for d, _ in outs], 0)[:h]
    if corrmap:
        return disp, mesh.all_gather([c for _, c in outs], 0)[:h]
    return disp


def match_batched_sharded(stacks0, stacks1, cfg: Config = Config(), *,
                          mesh=None, corrmap: bool = False,
                          backend: str = "auto"):
    """``(batch, n, H, W)`` pairs with the batch folded into the row axis
    (:func:`pipeline._fold_batch`) and the ``batch * H`` rows H-banded
    (:func:`match_sharded`). The stacks may also be :class:`RowBands` of
    folded pairs (``io.distribute_stack`` of a 4-d stack)."""
    if isinstance(stacks0, RowBands) and isinstance(stacks1, RowBands):
        if stacks0.batch < 1:
            raise ValueError("batched RowBands come from a (batch, n, H, W) "
                             "stack: io.distribute_stack of a 4-d stack")
        b = stacks0.batch
        _, bh, w = stacks0.shape
        h = bh // b
        flat0, flat1 = stacks0, stacks1
    else:
        flat0, flat1, (b, h, w) = _pipeline._fold_batch(stacks0, stacks1)
    out = match_sharded(flat0, flat1, cfg, mesh=mesh, corrmap=corrmap,
                        backend=backend)
    if corrmap:
        disp, corr = out
        return disp.reshape(b, h, w), corr.reshape(b, h, w)
    return out.reshape(b, h, w)


def wband_ring_visits(ndev: int, band: int, drange) -> list:
    """The ring visits that can contribute under a disparity range.

    Visit ``i`` brings band ``idx`` the right band ``src = (idx + i) %
    ndev``, a relative column offset ``rel = (src - idx) * band``: ``i *
    band`` for bands that do not wrap, ``(i - ndev) * band`` for those that
    do. With ``d = col0 - col1`` in ``[dmin, dmax]`` a visit contributes
    only when ``[-rel - (band-1), -rel + band-1]`` overlaps the range;
    visits empty for every band are skipped. Same list as
    ``libbicos_tpu.sharding.wband_ring_visits``."""
    if drange is None:
        return list(range(ndev))
    dmin, dmax = int(drange[0]), int(drange[1])

    def overlap(rel):
        return -rel - (band - 1) <= dmax and -rel + band - 1 >= dmin

    visits = []
    for i in range(ndev):
        rels = [i * band] if i == 0 else [i * band, (i - ndev) * band]
        if any(overlap(r) for r in rels):
            visits.append(i)
    return visits


def _ring_fold(mesh, visits, payloads, fold_visit) -> None:
    """Visit every index in ``visits`` (ascending), jumping skipped
    rotations with one composed shift per gap: at visit ``i`` the held band
    ``j`` (rank ``mesh.ranks[j]``) sees the payload of rank ``(rank + i) %
    size`` through ``fold_visit(j, src, payload)``."""
    pos = 0
    cur = payloads
    for i in visits:
        if i > pos:
            cur = mesh.shift(cur, i - pos)
            pos = i
        for j, rank in enumerate(mesh.ranks):
            fold_visit(j, (rank + i) % mesh.size, cur[j])


def _ring_minima(words0, words1, need_last: bool, mesh, band: int, w: int,
                 backend: str, drange=None):
    """Ring minima of the held left bands ``words0`` against every right
    band (``words1``: the held right bands, ``band`` columns each, ``w``
    real columns in all): per held band ``(cost, first, last-or-None)``,
    ``first = -1, last = -2`` where no pair is in ``drange``."""
    fold = (row_minima_band if backend == "cuda"
            else _search.row_minima_band_torch_words)
    band0 = words0[0].shape[1]
    mf = [torch.full(x.shape[:2], BIG, dtype=torch.int32, device=x.device)
          for x in words0]
    ml = [torch.full_like(m, BIG) if need_last else None for m in mf]

    def visit(j, src, cur):
        fold(words0[j], cur, mesh.ranks[j] * band0, src * band, mf[j], ml[j],
             w1_total=w, drange=drange)

    _ring_fold(mesh, wband_ring_visits(mesh.size, band, drange), words1,
               visit)
    return [_search.decode_minima(f, l, w) for f, l in zip(mf, ml)]


def _ring_consistency(words0, words1, need_last: bool, mesh, band: int,
                      w: int, backend: str, drange=None):
    """One ring of the fused Consistency step over the held bands (``band``
    columns each, ``w`` real columns in all): per held left band its
    forward ``(first, last-or-None)``, and the reverse ``(first1,
    last1-or-None)`` of every right column, ``(H, w)``, reduced over the
    mesh. ``first = -1, last = -2`` where no pair is in ``drange``."""
    fold = (row_minima_consistency_band if backend == "cuda"
            else _search.row_minima_consistency_band_torch_words)
    band0 = words0[0].shape[1]
    h = words0[0].shape[0]
    dev = words0[0].device
    mf = [torch.full(x.shape[:2], BIG, dtype=torch.int32, device=dev)
          for x in words0]
    ml = [torch.full_like(m, BIG) if need_last else None for m in mf]
    # The reverse minima of every right column, first (and last) stacked so
    # that one collective reduces both.
    rev = torch.full((2 if need_last else 1, h, mesh.size * band), BIG,
                     dtype=torch.int32, device=dev)
    rl = rev[1] if need_last else None

    def visit(j, src, cur):
        fold(words0[j], cur, mesh.ranks[j] * band0, src * band, mf[j], ml[j],
             rev[0], rl, w_total=w, drange=drange)

    _ring_fold(mesh, wband_ring_visits(mesh.size, band, drange), words1,
               visit)
    rev = mesh.reduce_min(rev)
    _, first1, last1 = _search.decode_minima(
        rev[0], rev[1] if need_last else None, w)
    fwd = [_search.decode_minima(f, l, w)[1:] for f, l in zip(mf, ml)]
    return fwd, (first1[:, :w],
                 None if last1 is None else last1[:, :w])


def row_minima_wband(words0, words1, need_last: bool, *, mesh,
                     backend: str = "auto", drange=None):
    """W-banded scan minima over a ring: ``(cost, first, last-or-None)``,
    each ``(H, W0)`` int32, for ``(H, W0, nw)`` and ``(H, W1, nw)`` int32
    words, as :func:`search.row_minima_torch_words` (``cost`` is defined
    where ``first >= 0``). ``drange``: inclusive ``(dmin, dmax)`` on ``col0
    - col1``; visits that cannot contribute are skipped."""
    w0, w1 = words0.shape[1], words1.shape[1]
    if max(w0, w1) > PACK_K:
        raise ValueError(f"image width > {PACK_K} not supported")
    backend = _search.resolve_backend(backend, words0, words1)
    b0 = _bands(words0, 1, mesh)
    b1 = _bands(words1, 1, mesh)
    res = _ring_minima(b0, b1, need_last, mesh, b1[0].shape[1], w1, backend,
                       drange)
    cost, first, last = (
        None if res[0][k] is None
        else mesh.all_gather([r[k] for r in res], 1)[:, :w0]
        for k in range(3))
    return cost, first, last


def match_sharded_w(stack0, stack1, cfg: Config = Config(), *, mesh=None,
                    corrmap: bool = False, backend: str = "auto"):
    """W-banded ``match`` for very wide images: each band transforms its
    own columns, the scan runs as a ring of right descriptor bands
    (:func:`row_minima_wband`'s engine; Consistency runs the same one ring
    with the fused step, which also folds the reverse minima of the right
    columns, reduces them over the mesh and reads them at every left
    pixel's best column), and agree checks each left band against the
    whole right row. The results equal :func:`pipeline.match`'s exactly.
    Same arguments as ``match``, plus ``mesh``."""
    mesh = make_mesh() if mesh is None else mesh
    stack0, stack1, backend = _pipeline._prepare(
        stack0, stack1, cfg, corrmap, backend, mesh.device)
    n, h, w = stack0.shape
    if w >= PACK_K:
        # The ring packs cost * PACK_K + col; w == PACK_K is refused too, as
        # by the JAX package, whose int16 band-local disparity shift could
        # then meet the -32768 sentinel on a valid pixel.
        raise ValueError(f"image width >= {PACK_K} not supported")
    s0b = _bands(stack0, 2, mesh)
    band = s0b[0].shape[2]
    words0 = [_search.transform_words(s, cfg.mode, backend) for s in s0b]
    words1 = [_search.transform_words(s, cfg.mode, backend)
              for s in _bands(stack1, 2, mesh)]
    offs = [r * band for r in mesh.ranks]
    variant = cfg.variant
    drange = cfg.disparity_range
    if isinstance(variant, NoDuplicates):
        fwd = _ring_minima(words0, words1, True, mesh, band, w, backend,
                           drange)
        disps = [_search._finish_nodupes(f, l, band, off)
                 for (_, f, l), off in zip(fwd, offs)]
    else:
        fwd, (first1, last1) = _ring_consistency(
            words0, words1, variant.no_dupes, mesh, band, w, backend, drange)
        disps = [_search._finish_gathered(
            variant, f, l, *_search._lookup_reverse(first1, last1, f), off)
            for (f, l), off in zip(fwd, offs)]

    corrs = None
    if cfg.nxcorr_threshold is not None:
        # Each process holds the whole right stack already (the inputs are
        # global), which is what the JAX path all-gathers.
        outs = [_agree_banded(d, s0, stack1, off, cfg, backend)
                for d, s0, off in zip(disps, s0b, offs)]
        disps = [d for d, _ in outs]
        corrs = [c for _, c in outs]
    disp = mesh.all_gather(disps, 1)[:, :w]
    if not corrmap:
        return disp
    return disp, mesh.all_gather(corrs, 1)[:, :w]


def _agree_banded(disp, stack0_band, stack1, offset: int, cfg: Config,
                  backend: str):
    """Agree for one left column band at global column ``offset`` against
    the whole right row: the disparity shifted to band-local columns
    (``col_local - (d - offset) = col_global - d``), and ``offset`` given
    back inside agree (exact integers before the float rounding)."""
    d_shift = torch.where(disp == _search.INVALID_I16, _search.INVALID_I16,
                          disp.to(torch.int32) - offset).to(torch.int16)
    return _pipeline.agree_stage(d_shift, stack0_band, stack1, cfg, backend,
                                 col_offset=offset)
