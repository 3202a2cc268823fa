"""A one-step check of the pipeline and of every sharded layout.

The counterpart of ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, example_args)``: the flagship pipeline
  (descriptor transform, Hamming search, NXCORR agree) as one call on
  small stacks.
* :func:`dryrun_multichip` runs every sharded layout on a virtual mesh of
  ``n_devices`` bands (:class:`sharding.LocalMesh`) on tiny shapes and
  holds each to the single call exactly: H-banding, the W-band ring's
  argmins, ``match_sharded_w``, ``match_batched_sharded``, and H- and
  W-banding with a disparity range.

The JAX dry run pins ``jax_platforms`` to the CPU; this one pins nothing
and takes ``device``: the card by default, ``"cpu"`` for the CPU. The JAX
``"xla"`` legs run the plain versions (``backend="torch"``) on that
device, its TPU-only ``"pallas_interpret"`` legs the kernels
(``backend="cuda"``) on a card and the plain versions on the CPU; each
leg is held to the single call of its own backend.
"""

from __future__ import annotations

import numpy as np
import torch

from . import descriptor as _descriptor
from . import search as _search
from . import sharding as _sharding
from .config import Config, TransformMode
from .pipeline import match, resolve_device


def entry(device=None):
    """``(fn, (stack0, stack1))``: ``fn(stack0, stack1) -> (disparity,
    corrmap)`` matches with a threshold of 0.5, min_variance 1.0 and
    LIMITED descriptors on ``device`` (None: the card), the JAX entry's
    configuration and inputs."""
    device = resolve_device(device)
    cfg = Config(nxcorr_threshold=0.5, min_variance=1.0,
                 mode=TransformMode.LIMITED)

    def fn(stack0, stack1):
        return match(stack0, stack1, cfg, corrmap=True, device=device)

    rng = np.random.default_rng(0)
    n, h, w = 6, 32, 64
    s0 = torch.from_numpy(rng.integers(0, 256, (n, h, w), dtype=np.uint8))
    s1 = torch.from_numpy(rng.integers(0, 256, (n, h, w), dtype=np.uint8))
    return fn, (s0.to(device), s1.to(device))


def _assert_equal(got, want, what: str) -> None:
    """Equal values and, for floats, the same NaN mask."""
    if got.is_floating_point():
        same = (torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.nan_to_num(got),
                                torch.nan_to_num(want)))
    else:
        same = torch.equal(got, want)
    if not same:
        raise AssertionError(f"{what} differs from the single call")


def dryrun_multichip(n_devices: int, *, device=None) -> None:
    """Run every sharded layout over ``n_devices`` bands of one device
    (None: the card) on tiny shapes; raises ``AssertionError`` where a
    layout differs from the single call."""
    device = resolve_device(device)
    mesh = _sharding.make_mesh(n_devices, virtual=True, device=device)
    kernels = "cuda" if device.type == "cuda" else "torch"

    rng = np.random.default_rng(0)
    n, h, w = 4, 8 * n_devices, 4 * n_devices
    s0 = torch.from_numpy(
        rng.integers(0, 256, (n, h, w), dtype=np.uint8)).to(device)
    s1 = torch.from_numpy(
        rng.integers(0, 256, (n, h, w), dtype=np.uint8)).to(device)
    cfg = Config(nxcorr_threshold=0.5, mode=TransformMode.LIMITED)
    ref = {b: match(s0, s1, cfg, backend=b, device=device)
           for b in ("torch", kernels)}

    # H-banded end-to-end pipeline (the production scale-out layout).
    disp = _sharding.match_sharded(s0, s1, cfg, mesh=mesh, backend="torch")
    _assert_equal(disp, ref["torch"], "match_sharded")

    # W-banded ring argmins against the single scan at the same words.
    w0 = _descriptor.descriptor_words(s0, cfg.mode)
    w1 = _descriptor.descriptor_words(s1, cfg.mode)
    c_w, f_w, l_w = _sharding.row_minima_wband(w0, w1, True, mesh=mesh,
                                               backend=kernels)
    c_1, f_1, l_1 = _search.row_minima_torch_words(w0, w1, True)
    _assert_equal(f_w, f_1, "row_minima_wband first")
    _assert_equal(l_w, l_1, "row_minima_wband last")
    _assert_equal(c_w, c_1, "row_minima_wband cost")

    # The full W-banded pipeline (ring search, agree of each column band).
    disp_w = _sharding.match_sharded_w(s0, s1, cfg, mesh=mesh,
                                       backend="torch")
    _assert_equal(disp_w, ref["torch"], "match_sharded_w")

    # The serving layout: a batch folded into the rows, H-banded.
    batch0 = torch.stack([s0, s0 ^ 1])
    batch1 = torch.stack([s1, s1 ^ 1])
    disp_b = _sharding.match_batched_sharded(batch0, batch1, cfg, mesh=mesh,
                                             backend="torch")
    _assert_equal(disp_b[0], ref["torch"], "match_batched_sharded")

    # The W-band ring on the kernels (the JAX fused Pallas band kernel).
    disp_wf = _sharding.match_sharded_w(s0, s1, cfg, mesh=mesh,
                                        backend=kernels)
    _assert_equal(disp_wf, ref[kernels], f"match_sharded_w ({kernels})")

    # A bounded disparity range composes with H-banding ...
    cfg_r = Config(nxcorr_threshold=0.5, mode=TransformMode.LIMITED,
                   disparity_range=(0, max(2, w // 4)))
    ref_r = {b: match(s0, s1, cfg_r, backend=b, device=device)
             for b in ("torch", kernels)}
    disp_r = _sharding.match_sharded(s0, s1, cfg_r, mesh=mesh,
                                     backend="torch")
    _assert_equal(disp_r, ref_r["torch"], "ranged match_sharded")

    # ... and with W-banding (the ranged ring prunes visits), plain and on
    # the kernels.
    for b in ("torch", kernels):
        disp_wr = _sharding.match_sharded_w(s0, s1, cfg_r, mesh=mesh,
                                            backend=b)
        _assert_equal(disp_wr, ref_r[b], f"ranged match_sharded_w ({b})")
