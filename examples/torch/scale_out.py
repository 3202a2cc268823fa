"""Scale-out demo of the PyTorch/CUDA port: H-band sharding and batched
throughput on a mesh.

On one device the mesh is virtual: 8 row bands held by this process
(``make_mesh(8, virtual=True)``), as one card or the CPU runs the sharded
paths::

    PYTHONPATH=. python examples/torch/scale_out.py [--device cpu]

Under ``torchrun`` each process is one band (NCCL on the cards, gloo with
``--device cpu``); rank 0 writes the scene as PNGs and every process loads
them with ``io.load_multihost_stack``, which puts only that process's row
bands on its device::

    PYTHONPATH=. torchrun --nproc-per-node 4 examples/torch/scale_out.py

Rows are epipolar-independent, so H-banding needs no collective but the
final gather.
"""

import argparse
import os
import shutil
import tempfile

import numpy as np

import libbicos_tpu_torch as bicos
from libbicos_tpu_torch import io as bio
from libbicos_tpu_torch.sharding import (
    make_mesh,
    match_batched_sharded,
    match_sharded,
)


def _scene_folder(s0, s1) -> str:
    """Rank 0 writes the scene as 8-bit PNGs (with OpenCV) into a new
    temporary folder; every rank gets its path."""
    import cv2
    import torch.distributed as dist

    folder = [None]
    if dist.get_rank() == 0:
        folder = [tempfile.mkdtemp(prefix="bicos-scale-out-")]
        for i in range(s0.shape[0]):
            cv2.imwrite(os.path.join(folder[0], f"{i}_left.png"), s0[i])
            cv2.imwrite(os.path.join(folder[0], f"{i}_right.png"), s1[i])
    dist.broadcast_object_list(folder, src=0)
    return folder[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default, or 'cpu'")
    ap.add_argument("--scene", default="10x256x320", metavar="NxHxW",
                    help="shots and size of the synthetic scene")
    args = ap.parse_args(argv)

    n, h, w = (int(x) for x in args.scene.split("x"))
    s0, s1, true_disp = bio.synthetic_stack_pair(n, h, w, seed=3)
    cfg = bicos.Config(nxcorr_threshold=0.7, min_variance=1.0)

    lead = True
    if "WORLD_SIZE" in os.environ:  # torchrun: one band a process
        import torch.distributed as dist

        from libbicos_tpu_torch.cli import _distributed

        world = int(os.environ["WORLD_SIZE"])
        mesh, _, lead = _distributed(world, args.device)
        folder = _scene_folder(s0, s1)
        d0, d1 = bio.load_multihost_stack(folder, mesh=mesh)
        dist.barrier()  # every rank has read the scene
        if lead:
            shutil.rmtree(folder)
        where = f"{world} processes"
    else:
        mesh = make_mesh(8, virtual=True, device=args.device)
        d0, d1 = (bio.distribute_stack(s, mesh=mesh) for s in (s0, s1))
        where = f"one device ({mesh.device})"
    dev = mesh.device
    say = print if lead else (lambda *a, **k: None)
    say(f"mesh: {mesh.size} row bands of {d0.bands[0].shape[1]} rows over "
        f"{where}")

    disp = match_sharded(d0, d1, cfg, mesh=mesh).cpu().numpy()
    ref = bicos.match(s0, s1, cfg, device=dev).cpu().numpy()
    say("sharded == single-device:", bool((disp == ref).all()))

    valid = disp != -32768
    say(f"valid {valid.mean():.2%}, "
        f"gt agreement {(disp[valid] == true_disp[valid]).mean():.2%}")

    # Batched throughput: fold a batch of stereo pairs into one call.
    batch = np.stack([s0, s0 ^ 1, s0 ^ 2, s0 ^ 3])
    batch1 = np.stack([s1, s1 ^ 1, s1 ^ 2, s1 ^ 3])
    out = bicos.match_batched(batch, batch1, cfg, device=dev).cpu().numpy()
    say("batched output:", out.shape, "pair0 matches:",
        bool((out[0] == ref).all()))

    # Serving layout: the whole batch H-banded over the mesh in one call.
    b0, b1 = (bio.distribute_stack(b, mesh=mesh) for b in (batch, batch1))
    outs = match_batched_sharded(b0, b1, cfg, mesh=mesh).cpu().numpy()
    say("batched+sharded matches batched:", bool((outs == out).all()))
    if "WORLD_SIZE" in os.environ:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
