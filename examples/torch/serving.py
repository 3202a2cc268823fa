"""Serving demo of the PyTorch/CUDA port: start the daemon in-process, hit
it with the client, and show that a warm request pays no start-up.

    PYTHONPATH=. python examples/torch/serving.py [--device cpu] [--port P]

On a card host you would instead run the daemon on its own —

    python -m libbicos_tpu_torch.serve --port 8344 --limited -t 0.9 -v 2.0 \\
        --warmup 33x2200x3300:u8

— and point ``BicosClient`` at it from any process: the CUDA context, the
kernel library and the first upload are paid once, at warmup.
"""

import argparse
import socket
import threading
import time

import numpy as np

import libbicos_tpu_torch as bicos
from libbicos_tpu_torch.client import BicosClient
from libbicos_tpu_torch.io import synthetic_stack_pair
from libbicos_tpu_torch.serve import Engine, serve


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default, or 'cpu'")
    ap.add_argument("--port", type=int, default=0, help="0: a free port")
    args = ap.parse_args(argv)
    port = args.port or _free_port()
    n, h, w = 10, 128, 160

    engine = Engine(bicos.Config(nxcorr_threshold=0.7, min_variance=1.0),
                    device=args.device)
    ready = threading.Event()
    threading.Thread(
        target=serve,
        args=(engine, "127.0.0.1", port),
        kwargs={"warmup_shapes": [((n, h, w), "uint8")],
                "ready_event": ready},
        daemon=True,
    ).start()
    ready.wait(300)
    print(f"daemon ready, {engine.compiled_count} specialization(s) warm")

    client = BicosClient(f"http://127.0.0.1:{port}")
    print("healthz:", client.healthz())

    s0, s1, true_disp = synthetic_stack_pair(n, h, w, seed=5)
    t0 = time.perf_counter()
    disp = client.match(s0, s1)
    print(f"warm request: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"(shape {disp.shape}, dtype {disp.dtype}; server match "
          f"{client.last_timing['server_match']:.1f} ms)")

    valid = disp != -32768
    agree = (disp[valid] == true_disp[valid]).mean()
    print(f"valid {valid.mean():.2%}, ground-truth agreement {agree:.2%}")

    # Config overrides per request: a new specialization runs on demand.
    disp_c, corr = client.match(s0, s1, corrmap=True, lr_maxdiff=1,
                                no_dupes=1)
    print(f"consistency variant: valid {(disp_c != -32768).mean():.2%}, "
          f"corrmap finite {np.isfinite(corr).mean():.2%}")
    print(f"specializations now warm: {client.healthz()['compiled']}")


if __name__ == "__main__":
    main()
