#!/usr/bin/env python3
"""The float32 control of a DOUBLE cell, at the cell's own size:

    python3 tools/single_control.py --workload double33.device --seeds 1,2,3

For each seed it makes the cell's pool of pairs as ``portbench`` makes
it, and judges with ``portbench.judge.compare``, against the cell's own
reference (float64 NXCORR), two answers of every pool pair:

* ``program``: the port with the configuration's precision set to
  SINGLE, ``pipeline.match(s0, s1, cfg, corrmap=True)`` on the card;
* ``reference``: the cell's reference with the compute type float32.

One JSON line per seed and side, with the seconds the float64 reference
took a pair. These are the ``upper_single`` readings of a DOUBLE cell's
``portbench/workloads/<cell>.json``: each must fail the cell's limits. It
needs a card, as ``portbench/run.py`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from libbicos_tpu_torch import pipeline
    from libbicos_tpu_torch.config import Precision
    from portbench import judge, spec, traffic

    if not torch.cuda.is_available():
        print("single_control: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    if cfg["precision"] != "DOUBLE":
        print(f"single_control: {args.workload} is not a DOUBLE cell",
              file=sys.stderr)
        return 2
    reference = spec.load_module("reference", cfg["reference"])
    single = dataclasses.replace(spec.port_config(cfg),
                                 precision=Precision.SINGLE)
    dev = torch.device("cuda", torch.cuda.current_device())
    for seed in (int(s) for s in args.seeds.split(",") if s):
        pool = traffic.make_pool(cfg, bench.traffic(cell["traffic"]), seed,
                                 dev)
        sides = {"program": [], "reference": []}
        secs = []
        for s0, s1 in pool:
            disp, corr = pipeline.match(s0, s1, single, corrmap=True)
            t0 = time.perf_counter()
            _, rdisp, rcorr = reference.match(s0, s1, cfg)
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t0)
            _, fdisp, fcorr = reference.match(s0, s1, cfg,
                                              dtype=torch.float32)
            sides["program"].append((disp, corr, rdisp, rcorr))
            sides["reference"].append((fdisp, fcorr, rdisp, rcorr))
        for side, pairs in sides.items():
            print(json.dumps({"workload": args.workload,
                              "side": f"single_{side}", "seed": seed,
                              "numbers": judge.compare(pairs),
                              "reference_s": secs}), flush=True)
        del pool, sides
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
