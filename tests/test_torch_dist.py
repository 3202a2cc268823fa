"""The sharded paths over ``torch.distributed`` (``DistMesh``, gloo on the
CPU, one band per process) against the same paths on a ``LocalMesh`` in
this process: equal disparities (same NaN mask), corrmaps and argmins, on
every rank, for 2 and 4 processes; Consistency's reverse minima travel by
``mesh.reduce_min`` (``all_reduce`` MIN), also checked on its own.

The file is its own worker, and imports only torch, numpy and the port::

    python tests/test_torch_dist.py <rank> <world> <store> <io.npz> <backend>
        [CLI ARGUMENTS...]

joins a ``<backend>`` group (gloo, or nccl with card ``<rank>``) through
the ``FileStore`` at ``<store>`` (no ports), runs every case on the stacks
in ``<io.npz>`` and writes its results to ``<io.npz>.<rank>.npz``; given
CLI arguments, it runs ``libbicos_tpu_torch.cli.main`` on them with
``--devices <world>`` instead (``tests/test_torch_cli.py``). Each
worker runs under a timeout, so a hang fails the test and never stalls the
suite. ``tests/test_torch_cuda.py`` runs the same group on NCCL.
"""

import concurrent.futures
import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

import libbicos_tpu_torch as tb  # noqa: E402
from libbicos_tpu_torch import sharding as tsh  # noqa: E402
from libbicos_tpu_torch.descriptor import descriptor_words  # noqa: E402
from libbicos_tpu_torch.io import synthetic_stack_pair  # noqa: E402

TIMEOUT = 120  # seconds for each worker, start-up included

W_CASES = {
    "w_nodup": tb.Config(nxcorr_threshold=0.6, subpixel_step=0.1),
    "w_cons": tb.Config(nxcorr_threshold=0.5, min_variance=1.0,
                        variant=tb.Consistency(1, True)),
    "w_nodup_range": tb.Config(nxcorr_threshold=0.5,
                               disparity_range=(0, 15)),
    "w_cons_range": tb.Config(nxcorr_threshold=0.6, subpixel_step=0.25,
                              variant=tb.Consistency(2, False),
                              disparity_range=(-6, 9)),
    "w_cons_nodupes_range": tb.Config(nxcorr_threshold=0.5,
                                      variant=tb.Consistency(1, True),
                                      disparity_range=(0, 15)),
}
H_CASES = {
    "h_nodup": tb.Config(nxcorr_threshold=0.5, subpixel_step=0.1),
    "h_cons_range": tb.Config(nxcorr_threshold=0.5,
                              variant=tb.Consistency(1, True),
                              disparity_range=(0, 12)),
}


def run_cases(s0, s1, mesh) -> dict:
    """Every case on one mesh, on the mesh's device (CUDA: the kernels):
    name -> numpy result."""
    out = {}
    for cases, fn in ((W_CASES, tsh.match_sharded_w),
                      (H_CASES, tsh.match_sharded)):
        for name, cfg in cases.items():
            disp, corr = fn(s0, s1, cfg, mesh=mesh, corrmap=True)
            out[f"{name}.disp"] = disp.cpu().numpy()
            out[f"{name}.corr"] = corr.cpu().numpy()
    # reduce_min: every band's int32 contribution, minimum-reduced. A
    # LocalMesh's one accumulator already holds every band's fold.
    parts = [torch.from_numpy(((np.arange(24, dtype=np.int64).reshape(2, 3, 4)
                                * (r + 3)) % 11 - r).astype(np.int32))
             for r in range(mesh.size)]
    mine = (torch.stack(parts).amin(0) if isinstance(mesh, tsh.LocalMesh)
            else parts[mesh.ranks[0]])
    out["reduce_min"] = mesh.reduce_min(mine.to(mesh.device)).cpu().numpy()
    mode = tb.TransformMode.LIMITED
    w0, w1 = (descriptor_words(torch.from_numpy(s).to(mesh.device), mode)
              for s in (s0, s1))
    for drange in (None, (0, 15)):
        cost, first, last = tsh.row_minima_wband(w0, w1, True, mesh=mesh,
                                                 drange=drange)
        out[f"wband{drange}.first"] = first.cpu().numpy()
        out[f"wband{drange}.last"] = last.cpu().numpy()
        out[f"wband{drange}.cost"] = torch.where(first >= 0, cost,
                                                 -1).cpu().numpy()
    return out


def _worker(rank: int, world: int, store: str, io: str,
            backend: str, cli_args=()) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT // 2))
    try:
        if cli_args:
            from libbicos_tpu_torch import cli

            rc = cli.main([*cli_args, "--devices", str(world), "--device",
                           str(device)])
            if rc != 0:
                raise RuntimeError(f"the CLI returned {rc}")
            return
        mesh = tsh.make_mesh(device=device)
        if not isinstance(mesh, tsh.DistMesh) or mesh.size != world:
            raise RuntimeError(f"expected a DistMesh of {world}, got {mesh}")
        try:
            tsh.make_mesh(world + 1)
        except ValueError:
            pass
        else:
            raise RuntimeError("make_mesh accepted a count != world size")
        data = np.load(io)
        np.savez(f"{io}.{rank}.npz", **run_cases(data["s0"], data["s1"],
                                                 mesh))
    finally:
        dist.destroy_process_group()


def _run_worker(rank, world, store, io, backend, env, cli_args=()):
    return subprocess.run(
        [sys.executable, __file__, str(rank), str(world), str(store),
         str(io), backend, *cli_args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=TIMEOUT)


def _assert_equal(name, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), name)
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m], name)
    else:
        np.testing.assert_array_equal(got, want, name)


def test_dist_cases_are_not_trivial():
    """The stacks the workers match give valid and invalid pixels in every
    case (so equality below says something)."""
    s0, s1, _ = synthetic_stack_pair(5, 6, 42, seed=3)
    res = run_cases(s0, s1, tsh.make_mesh(4, virtual=True, device="cpu"))
    for name, arr in res.items():
        if name.endswith(".disp"):
            invalid = np.isnan(arr) if arr.dtype.kind == "f" else arr == -32768
            assert invalid.any() and (~invalid).any(), name


def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def start_group(tmp_path, world, io, backend="gloo", cli_args=()):
    """``world`` workers of one group; their completed processes."""
    import pytest

    env = _worker_env()
    with concurrent.futures.ThreadPoolExecutor(world) as pool:
        futs = [pool.submit(_run_worker, r, world, tmp_path / "store", io,
                            backend, env, cli_args) for r in range(world)]
        try:
            procs = [f.result() for f in futs]
        except subprocess.TimeoutExpired as e:
            pytest.fail(f"a worker of {world} hung past {TIMEOUT} s: {e}")
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, (
            f"rank {rank}: {proc.stdout}\n{proc.stderr}")
    return procs


def run_group(tmp_path, world, backend="gloo"):
    """``world`` worker processes on ``backend`` against a ``LocalMesh`` of
    ``world`` bands in this process (on card 0 for nccl)."""
    s0, s1, _ = synthetic_stack_pair(5, 6, 42, seed=3)
    # The reference first: on a card it also builds the kernels once.
    want = run_cases(s0, s1, tsh.make_mesh(
        world, virtual=True, device="cuda:0" if backend == "nccl" else "cpu"))
    io = tmp_path / "io.npz"
    np.savez(io, s0=s0, s1=s1)
    start_group(tmp_path, world, io, backend)
    for rank in range(world):
        got = np.load(f"{io}.{rank}.npz")
        assert sorted(got.files) == sorted(want)
        for name, arr in want.items():
            _assert_equal(f"rank {rank} {name}", got[name], arr)


def test_distmesh_two_processes_equal_localmesh(tmp_path):
    run_group(tmp_path, 2)


def test_distmesh_four_processes_equal_localmesh(tmp_path):
    run_group(tmp_path, 4)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5], sys.argv[6:])
