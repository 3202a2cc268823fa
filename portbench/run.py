#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload headline33.device --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the program, ``libbicos_tpu_torch``, on a machine with the
cards the cell asks for. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy time and the breakdown. The last line of standard output is one JSON
object; the numbers that decide ``correct`` come last on standard error,
each beside its limit. Without a card, or with fewer cards than the cell
asks for, the run prints no result and exits with 2. See
``portbench/harness.py`` for what a run does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started,
    from ``/proc`` (10 ms ticks); the present reading where that fails."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now
    return now - age if 0 <= age < 600 else now


ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    # Build and kernel caches at fixed places inside the checkout.
    for var, name in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / ".portbench_cache" / name))
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    chips = int(spec.Benchmark(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available():
        print("portbench: no CUDA device: the benchmark runs on the card "
              "and never on the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    import libbicos_tpu_torch

    if ROOT not in Path(libbicos_tpu_torch.__file__).resolve().parents:
        print(f"portbench: the program under test is not this checkout's "
              f"({libbicos_tpu_torch.__file__})", file=sys.stderr)
        return 2
    return harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=t_start)


if __name__ == "__main__":
    sys.exit(main())
