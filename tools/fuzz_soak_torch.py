#!/usr/bin/env python
"""Long-soak differential fuzzer (CPU) of the PyTorch/CUDA port against the
JAX package, with the draw space and repro lines of ``tools/fuzz_soak.py``.

Modes:

* ``torch``: the port's ``match`` (plain PyTorch on the CPU) against the JAX
  ``match(backend="xla")`` on the same pair, ranges included. Where the
  two differ, the reference oracle (``libbicos_tpu._oracle``) judges: its
  agree stage runs on the search disparity (equal in both packages), and
  the trial passes only if the port equals it at every pixel where the
  two differ; the trial is then reported as a divergence of the JAX
  package from the reference;
* ``shard``: the port's ``match_sharded`` (full stacks, and the row bands
  of ``io.distribute_stack``) and ``match_sharded_w`` on a virtual mesh of
  2, 4 or 8 bands against its single ``match``;
* ``batched``: the port's ``match_batched`` against its per-pair
  ``match``.

The bar (ROADMAP, "The bar"): disparities exactly equal with the same NaN
mask, the corrmap within rtol = atol = 4e-6 of the JAX one; the port's
sharded and batched paths equal its single call exactly, corrmap
included. Any failure prints the seed, the trial and its context, then
continues (``BICOS_FUZZ_FAILFAST=1`` stops).

Usage: python tools/fuzz_soak_torch.py [--trials N] [--seed S]
                                       [--modes torch,shard,batched]
"""

import argparse
import dataclasses
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The JAX soak pins the CPU platform, its 8 virtual devices and strict f32
# when imported; its draws are the ones used here.
from fuzz_soak import draw_cfg, make_pair  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import libbicos_tpu as jb  # noqa: E402
from libbicos_tpu import _oracle as oracle  # noqa: E402

import libbicos_tpu_torch as tb  # noqa: E402
from libbicos_tpu_torch import io as tio  # noqa: E402
from libbicos_tpu_torch import sharding as tsh  # noqa: E402

CORR_TOL = dict(rtol=4e-6, atol=4e-6)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cmp_exact(got, want, ctx):
    """Equal dtype, shape and values, with the same NaN mask."""
    got, want = _np(got), _np(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), ctx
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), ctx)
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m], ctx)
    else:
        np.testing.assert_array_equal(got, want, ctx)


def _both(fn, cfg, *args, **kw):
    """``fn(*args, cfg, corrmap=...)`` as ``(disparity, corrmap-or-None)``."""
    if cfg.nxcorr_threshold is None:
        return fn(*args, cfg, **kw), None
    return fn(*args, cfg, corrmap=True, **kw)


def _differ(got_d, got_c, want_d, want_c):
    """Pixels whose disparities differ (NaN counts as a value) or whose
    corrmaps lie beyond the tolerance."""
    got_d, want_d = _np(got_d), _np(want_d)
    bad = ~((got_d == want_d) | (np.isnan(got_d.astype(np.float32))
                                 & np.isnan(want_d.astype(np.float32))))
    if want_c is not None:
        got_c, want_c = _np(got_c), np.asarray(want_c)
        close = np.isclose(got_c, want_c, equal_nan=True,
                           rtol=CORR_TOL["rtol"], atol=CORR_TOL["atol"])
        bad |= ~close
    return bad


def _oracle_agree(search_disp, s0, s1, jcfg):
    """The reference's agree stage on a search disparity."""
    n = s0.shape[0]
    minvar = None if jcfg.min_variance is None else jcfg.min_variance * n
    disp = np.array(search_disp, dtype=np.int16)  # agree writes into it
    if jcfg.subpixel_step is not None:
        return oracle.agree_subpixel(disp, s0, s1, jcfg.nxcorr_threshold,
                                     jcfg.subpixel_step, minvar,
                                     s0.dtype.type)
    return oracle.agree(disp, s0, s1, jcfg.nxcorr_threshold, minvar)


def run_trial(fz, mode_name):
    """One trial; its context (the repro line) is noted on any exception."""
    jcfg, n = draw_cfg(fz, small=False, allow_range=True)
    cfg = tb.config_from_reference(jcfg)
    dtype = np.uint16 if fz.integers(4) == 0 else np.uint8
    if mode_name == "shard":
        h = int(fz.integers(3, 25))
        w = int(fz.integers(10, 70))
    else:
        h = int(fz.integers(3, 13))
        w = int(fz.integers(10, 42))
    s0, s1 = make_pair(fz, n, h, w, dtype)
    ctx = f"mode={mode_name} cfg={jcfg} n={n} {h}x{w} {dtype.__name__}"
    try:
        return _check(mode_name, fz, cfg, jcfg, s0, s1, ctx)
    except Exception as e:
        e.add_note(ctx)
        raise


def _check(mode_name, fz, cfg, jcfg, s0, s1, ctx):
    cpu = dict(device="cpu")
    ref_d, ref_c = _both(tb.match, cfg, s0, s1, **cpu)

    if mode_name == "torch":
        want_d, want_c = _both(jb.match, jcfg, s0, s1, backend="xla")
        bad = _differ(ref_d, ref_c, want_d, want_c)
        assert _np(ref_d).dtype == np.asarray(want_d).dtype, ctx
        if not bad.any():
            return ctx
        assert want_c is not None, ctx + " [search disparity]"
        # The oracle judges: its agree on the search disparity, which both
        # packages must share exactly.
        unthr = dict(nxcorr_threshold=None, subpixel_step=None)
        search = tb.match(s0, s1, dataclasses.replace(cfg, **unthr), **cpu)
        cmp_exact(search, jb.match(s0, s1, dataclasses.replace(jcfg, **unthr),
                                   backend="xla"), ctx + " [search]")
        od, oc = _oracle_agree(search.numpy(), s0, s1, jcfg)
        port_off = _differ(ref_d, ref_c, od, oc) & bad
        assert not port_off.any(), ctx + (
            f" [the port differs from the JAX package and from the oracle "
            f"at {np.argwhere(port_off).tolist()}]")
        return ctx + (f" [JAX xla differs from the oracle at "
                      f"{np.argwhere(bad).tolist()}; the port equals it]")

    if mode_name == "batched":
        b = int(fz.integers(2, 5))
        pairs = [(s0, s1)] + [(s0 ^ np.uint8(k), s1 ^ np.uint8(k))
                              for k in range(1, b)]
        b0 = np.stack([p[0] for p in pairs])
        b1 = np.stack([p[1] for p in pairs])
        got_d, got_c = _both(tb.match_batched, cfg, b0, b1, **cpu)
        for k in range(b):
            want_d, want_c = _both(tb.match, cfg, *pairs[k], **cpu)
            cmp_exact(got_d[k], want_d, ctx + f" [batched k={k}/{b}]")
            if want_c is not None:
                cmp_exact(got_c[k], want_c, ctx + f" [batched k={k}/{b}]")
        return ctx + f" batch={b}"

    # shard: the port's single call is the reference; sharded paths EXACT.
    size = int(fz.choice([2, 4, 8]))
    ctx += f" mesh={size}"
    mesh = tsh.make_mesh(size, virtual=True, device="cpu")
    bands = [tio.distribute_stack(s, mesh=mesh) for s in (s0, s1)]
    for label, fn, args in (("H-band", tsh.match_sharded, (s0, s1)),
                            ("H-band rows", tsh.match_sharded, bands),
                            ("W-band", tsh.match_sharded_w, (s0, s1))):
        got_d, got_c = _both(fn, cfg, *args, mesh=mesh)
        cmp_exact(got_d, ref_d, ctx + f" [{label}]")
        if ref_c is not None:
            cmp_exact(got_c, ref_c, ctx + f" [{label} corrmap]")
    return ctx


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=0,
                    help="0 = run until killed")
    ap.add_argument("--seed", type=int, default=int(time.time()))
    ap.add_argument("--modes", default="torch,shard,batched")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    fz = np.random.default_rng(args.seed)
    print(f"fuzz soak (port): seed={args.seed} modes={modes}", flush=True)
    failures = 0
    t = 0
    t0 = time.time()
    while args.trials == 0 or t < args.trials:
        mode_name = modes[t % len(modes)]
        try:
            ctx = run_trial(fz, mode_name)
            if t % 10 == 0 or "differs from the oracle" in ctx:
                print(f"[{t}] ok ({time.time() - t0:.0f}s) {ctx}",
                      flush=True)
        except Exception:
            failures += 1
            print(f"[{t}] FAILURE (seed={args.seed}):", flush=True)
            traceback.print_exc()
            if os.environ.get("BICOS_FUZZ_FAILFAST"):
                return 1
        t += 1
        if t % 50 == 0:
            jax.clear_caches()
    print(f"done: {t} trials, {failures} failures, "
          f"{time.time() - t0:.0f}s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
