#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/calibrate.py --workload headline33.device \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 21,22,23

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a short
window (``--seconds``), and prints the numbers that decide ``correct``
(the lower readings: sound runs of the program). For each of
``--control-seeds`` it puts the control in the program's place: the plain
reference with its statistics and NXCORR computed in bfloat16, the
precision next below the configuration's float32, on the same pool of
pairs, judged against the float32 reference (the upper readings). One line
of JSON per seed; the benchmark's own runs never run the control. It needs
a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, judge, spec, traffic

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    bench = spec.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    reference = spec.load_module("reference", cfg["reference"])
    dev = torch.device("cuda", torch.cuda.current_device())
    for seed in seeds:
        buf = io.StringIO()
        rc = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                              t_start=time.perf_counter(), out=buf)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(json.dumps({"workload": args.workload, "side": "program",
                          "seed": seed, "rc": rc,
                          "attempted": line["attempted"],
                          "numbers": {k: v["value"] for k, v in
                                      line["checks"].items()}}), flush=True)
    for seed in control:
        pool = traffic.make_pool(cfg, mix, seed, dev)
        pairs, secs = [], []
        for s0, s1 in pool:
            t0 = time.perf_counter()
            _, rdisp, rcorr = reference.match(s0, s1, cfg)
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t0)
            _, cdisp, ccorr = reference.match(s0, s1, cfg,
                                              dtype=torch.bfloat16)
            pairs.append((cdisp, ccorr, rdisp, rcorr))
        print(json.dumps({"workload": args.workload, "side": "control",
                          "seed": seed, "numbers": judge.compare(pairs),
                          "reference_s": secs}), flush=True)
        del pool, pairs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
