"""``bicos`` command line interface on the PyTorch/CUDA engine::

    python -m libbicos_tpu_torch.cli FOLDER0 [FOLDER1] [options]

The counterpart of ``libbicos_tpu.cli``, with the reference CLI's flags,
defaults and output lines:

* positional ``folder0 [folder1]`` (two-folder ``N.png`` layout, or
  single-folder ``N_left.png`` / ``N_right.png``);
* ``-t/--threshold`` 0.75 and ``--limited`` off (mode FULL): the CLI's
  defaults, not the library's; ``-t <= 0`` turns NXCORR off and
  ``--corrmap`` without a threshold forces -1;
* the variance prefilter only when ``-v`` is passed;
* ``-m/--lr-maxdiff`` selects Consistency, composable with ``--no-dupes``;
* ``-q/--qmatrix`` reprojects to an ascii ``.xyz`` point cloud
  (``--allow-negative-z`` keeps points behind the camera);
* the upload/match/download latency line, each phase fenced with
  ``torch.cuda.synchronize()`` on the card.

Beside them: ``--device`` (the card by default, ``cpu`` to run there),
``--backend auto|cuda|torch``, ``--profile DIR`` (a ``torch.profiler``
trace), ``--dump-descriptors NPZ`` (the packed descriptor words, checked
when ``BICOS_DEBUG`` is set), ``--disp-range MIN:MAX`` and ``--devices N``,
which shards over ``N`` processes of ``torch.distributed``
(``match_sharded``, or ``match_sharded_w`` with ``--shard-axis cols``):
run it under ``torchrun --nproc-per-node N``, or in processes that have
initialised the default group. Only rank 0 prints and writes files.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import io as _io
from .config import (
    Config, Consistency, NoDuplicates, Precision, TransformMode,
)


def _uint(s: str) -> int:
    """Non-negative int parser: the reference declares -n/-m unsigned, so
    -m -1 or -n -2 are refused when the arguments are parsed."""
    v = int(s)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be non-negative, got {s}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bicos",
        description="cli to process images with BICOS (PyTorch/CUDA engine)",
    )
    p.add_argument("folder0", help="First folder containing input images "
                   "with numbered names.")
    p.add_argument("folder1", nargs="?", default=None,
                   help="Optional second folder with input images. If "
                   "specified, file names need to be 0.png, 1.png... Else, "
                   "folder0 needs to contain 0_left.png, 0_right.png, "
                   "1_left.png...")
    p.add_argument("-t", "--threshold", type=float, default=0.75,
                   help="Minimum normalized cross correlation for a match "
                   "to be accepted. Set to 0.0 to disable. (default: 0.75)")
    # The reference declares a default of 1.0 but applies the prefilter
    # only when the flag is passed, so a default run has none.
    p.add_argument("-v", "--variance", type=float, default=None,
                   help="Minimum intensity variance. Only active with "
                   "--threshold. (default: 1.0)")
    p.add_argument("-s", "--step", type=float, default=None,
                   help="Stepsize for subpixel interpolation. Only effective "
                   "when threshold is set.")
    p.add_argument("-o", "--out", default="bicosdisp.png",
                   help="Output file for disparity image. "
                   "(default: bicosdisp.png)")
    p.add_argument("-n", "--stacksize", type=_uint, default=None,
                   help="Number of images to process. Defaults to all found "
                   "in the input folders.")
    p.add_argument("-q", "--qmatrix", default=None,
                   help="Path to cv::FileStorage with single matrix \"Q\" "
                   "for reconstructing a pointcloud.")
    p.add_argument("--allow-negative-z", action="store_true",
                   help="Allow for points with negative Z values in the "
                   "pointcloud output. Only effective with a given qmatrix.")
    p.add_argument("-m", "--lr-maxdiff", type=_uint, default=None,
                   help="Maximum disparity difference between left and right "
                   "image. Enabling this disables duplicate filtering.")
    p.add_argument("--double", action="store_true",
                   help="Set double instead of single precision")
    p.add_argument("--limited", action="store_true",
                   help="Limit transformation mode. Allows for more images "
                   "to be used.")
    p.add_argument("--corrmap", action="store_true",
                   help="Output map of normalized cross correlation values.")
    p.add_argument("--no-dupes", action="store_true",
                   help="Default BICOS variant when --lr-maxdiff is not "
                   "specified. Can be set together with --lr-maxdiff to "
                   "activate both.")
    p.add_argument("--devices", type=int, default=1,
                   help="Shard over this many processes of "
                   "torch.distributed (run under torchrun).")
    p.add_argument("--shard-axis", default="rows", choices=["rows", "cols"],
                   help="Sharding layout with --devices: 'rows' (H-banding, "
                   "zero-collective) or 'cols' (W-banding ring search for "
                   "very wide images).")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "torch"],
                   help="Compute path: the CUDA kernels, or plain PyTorch.")
    p.add_argument("--device", default=None,
                   help="Where to run: the current CUDA device by default, "
                   "or e.g. 'cpu' or 'cuda:1'.")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a torch.profiler trace into DIR.")
    p.add_argument("--dump-descriptors", default=None, metavar="NPZ",
                   help="Also write both stacks' packed descriptor words "
                        "to NPZ (debug artifact; keys words0/words1).")
    p.add_argument("--disp-range", default=None, metavar="MIN:MAX",
                   help="Restrict matching to disparities in the inclusive "
                        "range MIN:MAX (an extension; the reference always "
                        "scans the full row). Pixels without an in-range "
                        "candidate become invalid.")
    return p


def config_from_args(args) -> Config:
    """The reference CLI's mapping of its arguments to a ``Config``."""
    threshold = args.threshold
    if threshold is not None and threshold <= 0.0:
        threshold = None
    if args.corrmap and threshold is None:
        threshold = -1.0
        print(
            "Computing with nxcorr-threshold of -1.0 because 'corrmap' is "
            "set",
            file=sys.stderr,
        )
    minvar = args.variance if (args.variance and args.variance > 0) else None
    if args.lr_maxdiff is not None:
        variant = Consistency(
            max_lr_diff=args.lr_maxdiff, no_dupes=args.no_dupes
        )
    else:
        variant = NoDuplicates()
        if args.no_dupes:
            print(
                "'no-dupes' is the default when 'lr-maxdiff' is not set.",
                file=sys.stderr,
            )
    drange = None
    if getattr(args, "disp_range", None):
        try:
            lo, _, hi = args.disp_range.partition(":")
            drange = (int(lo), int(hi))
        except ValueError:
            raise SystemExit(
                f"--disp-range expects MIN:MAX integers, got "
                f"{args.disp_range!r}")
        if drange[0] > drange[1]:
            raise SystemExit(
                f"--disp-range expects MIN <= MAX, got {args.disp_range!r}")
    return Config(
        nxcorr_threshold=threshold,
        subpixel_step=args.step,
        min_variance=minvar,
        mode=TransformMode.LIMITED if args.limited else TransformMode.FULL,
        precision=Precision.DOUBLE if args.double else Precision.SINGLE,
        variant=variant,
        disparity_range=drange,
    )


# License banner printed like the reference CLI's; this project is an
# independent implementation, also LGPL (COPYING).
LICENSE_HEADER = (
    "libbicos-tpu  Copyright (C) 2026\n"
    "This program is free software, and you are welcome to redistribute\n"
    "it under the conditions of the GNU LGPL-3.0-or-later license.\n"
)


def _distributed(n: int, device, module: str = "libbicos_tpu_torch.cli"):
    """A mesh of ``n`` processes of ``torch.distributed``, this process's
    device and whether it is rank 0: the default group as it is, or
    initialised from the environment that ``torchrun`` sets (NCCL on the
    card, gloo on the CPU). ``module`` names the entry point in the
    error without ``torchrun``."""
    import torch.distributed as dist

    from .pipeline import resolve_device
    from .sharding import make_mesh

    if not dist.is_available():
        raise ValueError(f"--devices {n} needs torch.distributed, which this "
                         "torch lacks")
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(
                f"--devices {n} shards over {n} processes of "
                f"torch.distributed: run it as torchrun --nproc-per-node {n}"
                f" -m {module} ...")
        on_card = device is None or torch.device(device).type == "cuda"
        if on_card and device is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
        if on_card:
            torch.cuda.set_device(resolve_device(device))
        dist.init_process_group("nccl" if on_card else "gloo")
    mesh = make_mesh(n, device=device)
    return mesh, mesh.device, dist.get_rank() == 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .pipeline import resolve_device

    if args.device is None and not torch.cuda.is_available():
        raise ValueError("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    mesh, lead = None, True
    if args.devices > 1:
        mesh, dev, lead = _distributed(args.devices, args.device)
    else:
        dev = resolve_device(args.device)
    with contextlib.ExitStack() as quiet:
        if not lead:  # only rank 0 prints and writes
            devnull = quiet.enter_context(open(os.devnull, "w"))
            quiet.enter_context(contextlib.redirect_stdout(devnull))
            quiet.enter_context(contextlib.redirect_stderr(devnull))
        return _run(args, mesh, dev, lead)


def _run(args, mesh, dev, lead: bool) -> int:
    from .pipeline import match

    print(LICENSE_HEADER)
    if not sys.stdout.isatty():
        # As the reference: the CLI's output is not a stable interface.
        print("Danger: bicos-cli does not have a stable CLI interface",
              file=sys.stderr)

    lstack, rstack = _io.load_stack_pair(
        args.folder0, args.folder1, args.stacksize
    )
    if lstack.shape[0] != rstack.shape[0]:
        raise SystemExit(
            f"Left stack: {lstack.shape[0]}, right stack: "
            f"{rstack.shape[0]} images"
        )
    bits = lstack.dtype.itemsize * 8
    print(f"Loaded {lstack.shape[0] + rstack.shape[0]} {bits}-bit images "
          "in total")

    cfg = config_from_args(args)

    with contextlib.ExitStack() as profiling:
        if args.profile:
            from .profiling import trace

            profiling.enter_context(trace(args.profile))
        tick = time.perf_counter()
        l_dev = torch.from_numpy(lstack).to(dev)
        r_dev = torch.from_numpy(rstack).to(dev)
        _sync(dev)
        t_upload = (time.perf_counter() - tick) * 1e3
        print(f"Latency:\t {t_upload:.2f}ms (upload)\t", end="", flush=True)

        tick = time.perf_counter()
        if mesh is not None:
            from . import sharding

            fn = (sharding.match_sharded_w if args.shard_axis == "cols"
                  else sharding.match_sharded)
            out = fn(l_dev, r_dev, cfg, mesh=mesh, corrmap=args.corrmap,
                     backend=args.backend)
        else:
            out = match(l_dev, r_dev, cfg, corrmap=args.corrmap,
                        backend=args.backend, device=dev)
        _sync(dev)
        t_match = (time.perf_counter() - tick) * 1e3
        print(f"{t_match:.2f}ms (match)\t", end="", flush=True)

        tick = time.perf_counter()
        disp, corr = out if args.corrmap else (out, None)
        disp = disp.cpu().numpy()
        corr = None if corr is None else corr.cpu().numpy()
        t_down = (time.perf_counter() - tick) * 1e3
        print(f"{t_down:.2f}ms (download)")
    if args.profile:
        print(f"Saved profiler trace to {args.profile}")

    if lead:
        outfile = Path(args.out)
        _io.save_image(disp, outfile)
        if corr is not None:
            corr_out = outfile.parent / (outfile.stem + "-corrmap"
                                         + outfile.suffix)
            # VIRIDIS for the correlation map, as the reference.
            _io.save_image(corr, corr_out, colormap="viridis")

        if args.qmatrix:
            q = _io.read_q_matrix(args.qmatrix)
            points = _io.reproject_image_to_3d(disp, q)
            _io.save_pointcloud(points, disp, outfile, args.allow_negative_z)

    if args.dump_descriptors and lead:
        _dump_descriptors(args, cfg, l_dev, r_dev)
    return 0


def _dump_descriptors(args, cfg: Config, l_dev, r_dev) -> None:
    """The packed descriptor words of both stacks (uint32, ``(H, W, nw)``,
    as the JAX CLI writes them), checked by ``debug`` when enabled."""
    from . import debug as _debug
    from .config import validate_stack
    from .search import resolve_backend, transform_words

    backend = resolve_backend(args.backend, l_dev)
    words0, words1 = (transform_words(s, cfg.mode, backend).cpu().numpy()
                      .view(np.uint32) for s in (l_dev, r_dev))
    if _debug.enabled():
        nbits = validate_stack(l_dev.shape[0], cfg.mode)
        _debug.check_descriptor_words(words0, nbits)
        _debug.check_descriptor_words(words1, nbits)
    np.savez_compressed(args.dump_descriptors, words0=words0, words1=words1)
    print(f"Saved packed descriptors to\t{args.dump_descriptors}")


def _entry() -> int:
    """Console entry: user errors as one line, without a traceback."""
    try:
        return main()
    except (FileNotFoundError, NotADirectoryError, ValueError) as e:
        print(f"bicos: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(_entry())
