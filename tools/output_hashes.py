"""Hash the port's answers on the card, so that two commits can be shown
equal bit for bit without holding both sets of maps::

    python3 tools/output_hashes.py [TREE] [--seed N ...]

``TREE`` (default: this checkout) is the root of the commit whose
``libbicos_tpu_torch`` and ``portbench`` are imported; run the script once
per tree in one call and compare the lines. It hashes (sha256 of the
bytes, NaNs included) the disparity and the corrmap of
``match(..., corrmap=True)`` for

* ``chip_smoke.py``'s full-size calls A, B, C, D (n=33 LIMITED,
  NoDuplicates or Consistency(1, True), with and without the range (0,
  511)), I (A with ``BICOS_AGREE_DYNWIN=640``, chunk 256), J (A in
  DOUBLE) and N (``full16``'s settings on the first 16 shots), on
  ``synthetic_stack_pair(33, 2200, 3300)``;
* each pool pair of each benchmark cell (``BENCHMARK.json``), made from
  each ``--seed`` (default 7) as ``portbench`` makes it.

Each line is ``<label> <disparity sha256> <corrmap sha256>``; the last is
one JSON object of them all.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys
from pathlib import Path


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--seed", type=int, action="append")
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    sys.path.insert(0, str(root))

    import torch

    import libbicos_tpu_torch as tb
    from libbicos_tpu_torch.io import synthetic_stack_pair
    from portbench import spec, traffic

    dev = torch.device("cuda", 0)
    out = {}

    def record(label, cfg, s0, s1, env=None):
        saved = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        try:
            d, c = tb.match(s0, s1, cfg, corrmap=True)
            torch.cuda.synchronize()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[label] = [digest(d), digest(c)]
        print(label, *out[label], flush=True)

    s0, s1, _ = synthetic_stack_pair(33, 2200, 3300)
    s0, s1 = (torch.from_numpy(s).to(dev) for s in (s0, s1))

    def headline(variant, drange=None):
        return tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                         min_variance=2.0, mode=tb.TransformMode.LIMITED,
                         variant=variant, disparity_range=drange)

    a = headline(tb.NoDuplicates())
    record("A", a, s0, s1)
    record("B", headline(tb.Consistency(1, True)), s0, s1)
    record("C", headline(tb.NoDuplicates(), (0, 511)), s0, s1)
    record("D", headline(tb.Consistency(1, True), (0, 511)), s0, s1)
    record("I", a, s0, s1, {"BICOS_AGREE_DYNWIN": "640",
                            "BICOS_AGREE_CHUNK": "256"})
    record("J", dataclasses.replace(a, precision=tb.Precision.DOUBLE), s0,
           s1)
    record("N", tb.Config(nxcorr_threshold=0.9,
                          mode=tb.TransformMode.FULL),
           s0[:16].contiguous(), s1[:16].contiguous())
    del s0, s1

    bench = spec.Benchmark(root)
    for seed in args.seed or [7]:
        for cell in bench.data["workloads"]:
            cfg = bench.config(cell["config"])
            pool = traffic.make_pool(cfg, bench.traffic(cell["traffic"]),
                                     seed, dev)
            for p, (a0, a1) in enumerate(pool):
                record(f"{cell['name']}/seed{seed}/pair{p}",
                       spec.port_config(cfg), a0, a1)
            del pool
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
