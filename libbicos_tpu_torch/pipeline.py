"""End-to-end BICOS matching: transform, search, agree.

The counterpart of ``libbicos_tpu.pipeline``, eager PyTorch:

* int16 disparity (-32768 invalid) without subpixel refinement, float32
  with NaN invalid with it;
* ``min_variance`` is scaled by the stack size before use (the reference
  quirk);
* ``corrmap`` returns the NXCORR map too (needs a threshold);
* ``Precision.DOUBLE`` runs the agree stage's statistics, NXCORR and tests
  in float64 (the parabola and the x grid stay float32), on both backends.

``device`` is where a call runs. ``None`` means the card: CUDA inputs stay
on their device, CPU inputs move to the current CUDA device, and without a
card the call raises (pass ``device="cpu"`` to run on the CPU). ``backend``:
``"torch"`` runs the plain versions on that device, ``"cuda"`` the
hand-written kernels (it raises for CPU tensors), ``"auto"`` resolves to
``"cuda"`` on a card and to ``"torch"`` on the CPU.

Both search variants (NoDuplicates, Consistency), ``cfg.disparity_range``
and both precisions run on both backends. ``BICOS_AGREE_DYNWIN`` (read at
call time, see :func:`kernels.agree.agree_window`) turns on the agree
stage's dynamic window: per (row, chunk) bases computed from the
disparity, which the agree kernel uses to stage right-series windows in
shared memory. The results do not change. ``BICOS_DEBUG`` (read at call
time) makes ``match`` check its result (see :mod:`debug`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import agree as _agree
from . import search as _search
from .config import Config, Precision, validate_stack
from .kernels.agree import agree_cuda, agree_window
from .kernels.bases import chunk_window_bases_cuda
from .profiling import span


def resolve_device(device, like: Optional[torch.Tensor] = None
                   ) -> torch.device:
    """The device a call runs on. ``None``: the device of ``like`` if that
    is a card, else the current CUDA device; without a card it raises and
    never carries on on the CPU."""
    if device is None:
        if like is not None and like.device.type == "cuda":
            return like.device
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the entry points run on the card by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for but none is "
                           "available")
    return device


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a tensor or numpy array, got {type(x)}")
    return x.to(resolve_device(device, x)).contiguous()


_DEPTHS = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16}


def check_stacks(shape0, shape1, dtype0, dtype1, cfg: Config,
                 corrmap: bool) -> None:
    """The checks of a request that need only its metadata, in ``match``'s
    order: shapes, depths (torch or numpy dtypes), the stack size for
    ``cfg.mode`` and corrmap's threshold. Raises ``ValueError``."""
    dtype0, dtype1 = (_DEPTHS.get(d, d) if isinstance(d, np.dtype) else d
                      for d in (dtype0, dtype1))
    if len(shape0) != 3 or len(shape1) != 3:
        raise ValueError("stacks must have shape (n, H, W)")
    if tuple(shape0) != tuple(shape1):
        raise ValueError(
            f"stack shapes differ: {tuple(shape0)} vs {tuple(shape1)}")
    if dtype0 != dtype1:
        raise ValueError("stack dtypes differ")
    if dtype0 not in (torch.uint8, torch.uint16):
        raise ValueError(
            "bad input depths, only uint8 and uint16 are supported")
    validate_stack(shape0[0], cfg.mode)
    if corrmap and cfg.nxcorr_threshold is None:
        raise ValueError("corrmap requires cfg.nxcorr_threshold")


def _prepare(stack0, stack1, cfg: Config, corrmap: bool, backend: str,
             device):
    """The checks every matching surface makes, in ``match``'s order:
    ``(stack0, stack1, resolved backend)`` on the run's device."""
    with span("bicos.prepare"):
        if backend not in _search.BACKENDS:
            raise ValueError(
                f"backend must be one of {_search.BACKENDS}, got {backend!r}")
        stack0 = _as_tensor(stack0, device)
        stack1 = _as_tensor(stack1, device)
        if stack0.device != stack1.device:
            raise ValueError("stacks lie on different devices")
        check_stacks(stack0.shape, stack1.shape, stack0.dtype, stack1.dtype,
                     cfg, corrmap)
        return stack0, stack1, _search.resolve_backend(backend, stack0,
                                                       stack1)


def _agree_window_params(stack0, cfg: Config):
    """``(chunk, wcap, wp)`` when the agree stage runs the dynamic window,
    else None: the counterpart of ``libbicos_tpu.pipeline
    ._agree_bases_params`` (SINGLE, a threshold, a window that
    ``resolve_chunk_wcap`` accepts at this width) without the TPU's gather
    test."""
    if cfg.nxcorr_threshold is None or cfg.precision != Precision.SINGLE:
        return None
    w = stack0.shape[2]
    chunk, wcap = agree_window(w)
    if not wcap:
        return None
    return chunk, wcap, w + ((-w) % chunk)


def agree_stage(disp, stack0, stack1, cfg: Config, backend: str,
                col_offset: int = 0, window=None):
    """The agree stage: ``(disparity, corrmap)``, int16 without subpixel
    refinement, f32 with it. ``stack1`` may be wider than ``stack0`` and
    ``col_offset`` nonzero on the W-banded path (see
    :func:`agree.agree_subpixel`). ``window = (chunk, wcap, wp)`` runs the
    kernel's dynamic window with bases computed here from ``disp``; the
    plain backend reads any column and ignores it."""
    with span("bicos.agree"):
        minvar = (None if cfg.min_variance is None
                  else cfg.min_variance * stack0.shape[0])
        step = cfg.subpixel_step
        if backend == "cuda":
            chunk = wcap = 0
            bases = None
            if window is not None:
                chunk, wcap, wp = window
                bases = chunk_window_bases_cuda(disp, stack0.shape[2], wp,
                                                wcap, chunk)
            out_f, corr = agree_cuda(disp, stack0, stack1,
                                     cfg.nxcorr_threshold, step, minvar,
                                     col_offset, bases=bases, chunk=chunk,
                                     wcap=wcap, precision=cfg.precision)
            if step is not None:
                return out_f, corr
            with span("bicos.agree_finish"):
                return torch.where(
                    torch.isnan(out_f), _agree.INVALID_I16,
                    torch.nan_to_num(out_f).to(torch.int32)
                ).to(torch.int16), corr
        if step is not None:
            return _agree.agree_subpixel(disp, stack0, stack1,
                                         cfg.nxcorr_threshold, step, minvar,
                                         col_offset, cfg.precision)
        return _agree.agree_integer(disp, stack0, stack1,
                                    cfg.nxcorr_threshold, minvar, col_offset,
                                    cfg.precision)


def match(stack0, stack1, cfg: Config = Config(), *, corrmap: bool = False,
          backend: str = "auto", device=None):
    """Match two multishot stereo stacks.

    Args:
      stack0/stack1: ``(n, H, W)`` uint8 or uint16 rectified stacks (left,
        right), as tensors or numpy arrays.
      cfg: matching configuration.
      corrmap: also return the NXCORR map (float32, NaN where not
        computed). Requires ``cfg.nxcorr_threshold``.
      backend: ``"auto"`` | ``"torch"`` | ``"cuda"``.
      device: where to run (None: the card, see the module docstring);
        the inputs are moved there.

    Returns:
      ``disparity`` on the run's device, or ``(disparity, corrmap)``.
    """
    with span("bicos.match"):
        stack0, stack1, backend = _prepare(stack0, stack1, cfg, corrmap,
                                           backend, device)
        disp = _search.search_stack(stack0, stack1, cfg.mode, cfg.variant,
                                    backend=backend,
                                    drange=cfg.disparity_range)
        # The agree stage takes no range. The JAX package widens its agree
        # windows by ceil(max_lr_diff / 2) for a ranged Consistency search
        # (whose matched column can sit that far outside the range), but
        # those windows exist only for the TPU's static gathers: both agree
        # versions here read any column, and invalidate a matched column
        # outside the row as the JAX XLA agree does.
        corr = None
        if cfg.nxcorr_threshold is not None:
            disp, corr = agree_stage(disp, stack0, stack1, cfg, backend,
                                     window=_agree_window_params(stack0, cfg))
        from . import debug as _debug

        if _debug.enabled():
            # BICOS_DEBUG's invariant checks (see debug.py); they fetch the
            # results to the host.
            with span("bicos.debug"):
                _debug.check_match_output(
                    disp, corr, stack0.shape[2],
                    subpixel=cfg.subpixel_step is not None)
        if corrmap:
            return disp, corr
        return disp


def match_batched(stacks0, stacks1, cfg: Config = Config(), *,
                  corrmap: bool = False, backend: str = "auto", device=None):
    """Batched matching over ``(batch, n, H, W)`` stacks: rows are
    independent, so the batch is folded into the row axis and matched in
    one call."""
    with span("bicos.match"):
        flat0, flat1, (b, _, _) = _fold_batch(stacks0, stacks1)
        return match_batched_folded(flat0, flat1, b, cfg, corrmap=corrmap,
                                    backend=backend, device=device)


def match_batched_folded(flat0, flat1, batch: int, cfg: Config = Config(),
                         *, corrmap: bool = False, backend: str = "auto",
                         device=None):
    """Batched matching on pre-folded ``(n, batch*H, W)`` stacks; returns
    per-pair ``(batch, H, W)`` maps."""
    with span("bicos.match"):
        if flat0.ndim != 3 or tuple(flat0.shape) != tuple(flat1.shape):
            raise ValueError(
                "folded stacks must share one (n, batch*H, W) shape")
        if batch < 1 or flat0.shape[1] % batch:
            raise ValueError(f"row count {flat0.shape[1]} is not a multiple "
                             f"of batch {batch}")
        h = flat0.shape[1] // batch
        w = flat0.shape[2]
        out = match(flat0, flat1, cfg, corrmap=corrmap, backend=backend,
                    device=device)
        if corrmap:
            disp, corr = out
            return disp.reshape(batch, h, w), corr.reshape(batch, h, w)
        return out.reshape(batch, h, w)


def _fold_batch(stacks0, stacks1):
    """Fold ``(batch, n, H, W)`` pairs into ``(n, batch*H, W)``. Shapes must
    match exactly: a coincidental ``batch*H`` match would pair rows of
    different images."""
    stacks0 = torch.as_tensor(stacks0)
    stacks1 = torch.as_tensor(stacks1)
    if stacks0.dim() != 4 or stacks1.dim() != 4:
        raise ValueError("batched stacks must have shape (batch, n, H, W)")
    if stacks0.shape != stacks1.shape:
        raise ValueError(
            f"batched stacks must have identical shapes, got "
            f"{tuple(stacks0.shape)} vs {tuple(stacks1.shape)}")
    b, n, h, w = stacks0.shape
    flat0 = stacks0.movedim(0, 1).reshape(n, b * h, w)
    flat1 = stacks1.movedim(0, 1).reshape(n, b * h, w)
    return flat0, flat1, (b, h, w)
