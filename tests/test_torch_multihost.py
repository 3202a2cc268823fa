"""Multi-process loading and serving of the port over ``torch.distributed``
(gloo on the CPU, one band per process): ``io.distribute_stack`` and
``io.load_multihost_stack`` put only each rank's row bands on its device,
``sharding.match_sharded`` / ``match_batched_sharded`` on them equal the
single ``match``, and ``serve --devices 2`` answers a request with rank 1
following rank 0, both exiting 0 after SIGINT to rank 0.

The file is its own worker, and imports only torch, numpy and the port::

    python tests/test_torch_multihost.py <rank> <world> <store> <io.npz>
        <backend> bands|serve [SERVE ARGUMENTS...]

joins a ``<backend>`` group through the ``FileStore`` at ``<store>`` (the
harness of ``tests/test_torch_dist.py``) and either runs the band cases
on the stacks in ``<io.npz>``, writing ``<io.npz>.<rank>.npz``, or runs
``libbicos_tpu_torch.serve.main`` with ``--devices <world>``. Every worker
runs under a timeout.
"""

import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

import libbicos_tpu_torch as tb  # noqa: E402
from libbicos_tpu_torch import io as tio  # noqa: E402
from libbicos_tpu_torch import sharding as tsh  # noqa: E402

TIMEOUT = 120  # seconds for each worker, start-up included
CFG = tb.Config(nxcorr_threshold=0.5, min_variance=1.0, subpixel_step=0.25,
                variant=tb.Consistency(1, True))
SERVE_CFG = tb.Config(nxcorr_threshold=0.5, min_variance=1.0,
                      mode=tb.TransformMode.FULL)  # serve without --limited


def band_cases(s0, s1, mesh, folder) -> dict:
    """Every band case on ``mesh``: name -> numpy result."""
    out = {}
    r0, r1 = (tio.distribute_stack(s, mesh=mesh) for s in (s0, s1))
    out["band_shapes"] = np.array([b.shape for b in r0.bands + r1.bands])
    out["band0"] = r0.bands[0].cpu().numpy()
    disp, corr = tsh.match_sharded(r0, r1, CFG, mesh=mesh, corrmap=True)
    out["sharded.disp"], out["sharded.corr"] = disp.numpy(), corr.numpy()
    b0 = np.stack([s0, s0 ^ np.uint8(5)])
    b1 = np.stack([s1, s1 ^ np.uint8(5)])
    rb0, rb1 = (tio.distribute_stack(b, mesh=mesh) for b in (b0, b1))
    out["batched_band_shapes"] = np.array([b.shape for b in rb0.bands])
    out["batched.disp"] = tsh.match_batched_sharded(
        rb0, rb1, CFG, mesh=mesh).numpy()
    l0, l1 = tio.load_multihost_stack(folder, mesh=mesh)
    out["multihost_band_shapes"] = np.array([b.shape for b in l0.bands])
    out["multihost.disp"] = tsh.match_sharded(l0, l1, CFG,
                                              mesh=mesh).numpy()
    return out


def _worker(rank: int, world: int, store: str, io: str, backend: str,
            mode: str, args=()) -> int:
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
        if mode == "serve":
            from libbicos_tpu_torch import serve

            return serve.main([*args, "--devices", str(world), "--device",
                               str(device)])
        data = np.load(io)
        mesh = tsh.make_mesh(device=device)
        np.savez(f"{io}.{rank}.npz", **band_cases(
            data["s0"], data["s1"], mesh, str(data["folder"])))
        return 0
    finally:
        dist.destroy_process_group()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _popen(rank, world, tmp_path, io, backend, mode, args=()):
    return subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world),
         str(tmp_path / "store"), str(io), backend, mode, *args], cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout=TIMEOUT):
    """Wait for every worker (killing the rest on a hang); their
    ``(returncode, stdout, stderr)``."""
    import pytest

    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a worker of {len(procs)} hung past {timeout} s")
    return out


def run_bands(tmp_path, world):
    s0, s1, _ = tio.synthetic_stack_pair(5, 7, 40, seed=4)
    from chip_smoke import write_stack_folder

    write_stack_folder(tmp_path / "imgs", s0, s1)
    io = tmp_path / "io.npz"
    np.savez(io, s0=s0, s1=s1, folder=str(tmp_path / "imgs"))
    procs = [_popen(r, world, tmp_path, io, "gloo", "bands")
             for r in range(world)]
    for rank, (rc, o, e) in enumerate(_finish(procs)):
        assert rc == 0, f"rank {rank}: {o}\n{e}"
    want_d, want_c = tb.match(s0, s1, CFG, corrmap=True, device="cpu")
    band = -(-7 // world)
    pad = np.zeros((5, band * world - 7, 40), np.uint8)
    want_b = tb.match_batched(np.stack([s0, s0 ^ np.uint8(5)]),
                              np.stack([s1, s1 ^ np.uint8(5)]), CFG,
                              device="cpu").numpy()
    for rank in range(world):
        got = np.load(f"{io}.{rank}.npz")
        # Each rank holds its own row band of each stack, not the stack.
        np.testing.assert_array_equal(got["band_shapes"],
                                      [(5, band, 40)] * 2)
        np.testing.assert_array_equal(got["multihost_band_shapes"],
                                      [(5, band, 40)])
        np.testing.assert_array_equal(got["batched_band_shapes"],
                                      [(5, -(-14 // world), 40)])
        np.testing.assert_array_equal(
            got["band0"],
            np.concatenate([s0, pad], 1)[:, rank * band:(rank + 1) * band])
        for name, want in (("sharded.disp", want_d.numpy()),
                           ("multihost.disp", want_d.numpy())):
            np.testing.assert_array_equal(np.isnan(got[name]),
                                          np.isnan(want), name)
            np.testing.assert_array_equal(np.nan_to_num(got[name]),
                                          np.nan_to_num(want), name)
        np.testing.assert_allclose(got["sharded.corr"], want_c.numpy(),
                                   rtol=0, atol=0, equal_nan=True)
        np.testing.assert_array_equal(np.nan_to_num(got["batched.disp"]),
                                      np.nan_to_num(want_b))


def test_distribute_stack_two_processes(tmp_path):
    run_bands(tmp_path, 2)


def test_distribute_stack_four_processes(tmp_path):
    run_bands(tmp_path, 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_serve(tmp_path, world, backend="gloo", device="cpu"):
    """``serve --devices world``: rank 0 serves one request, equal to
    ``match`` on ``device``; SIGINT to rank 0 stops every rank with
    exit 0."""
    from libbicos_tpu_torch.client import BicosClient

    port = _free_port()
    args = ["--port", str(port), "-t", "0.5", "-v", "1.0",
            "--warmup", "3x5x16:u8"]
    procs = [_popen(r, world, tmp_path, tmp_path / "unused.npz", backend,
                    "serve", args) for r in range(world)]
    try:
        client = BicosClient(f"http://127.0.0.1:{port}", timeout=60)
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                health = client.healthz()
                break
            except OSError:
                if (time.monotonic() > deadline
                        or any(p.poll() is not None for p in procs)):
                    raise
                time.sleep(0.2)
        assert health == {"status": "ok", "compiled": 1}
        s0, s1, _ = tio.synthetic_stack_pair(4, 9, 30, seed=6)
        got_d, got_c = client.match(s0, s1, corrmap=True)
        want_d, want_c = tb.match(s0, s1, SERVE_CFG, corrmap=True,
                                  device=device)
        np.testing.assert_array_equal(got_d, want_d.cpu().numpy())
        np.testing.assert_array_equal(got_c, want_c.cpu().numpy())
        assert client.healthz()["compiled"] == 2
    finally:
        procs[0].send_signal(signal.SIGINT)
        results = _finish(procs)
    for rank, (rc, o, e) in enumerate(results):
        assert rc == 0, f"rank {rank}: {o}\n{e}"


def test_serve_two_processes(tmp_path):
    run_serve(tmp_path, 2)


def test_serve_four_processes(tmp_path):
    run_serve(tmp_path, 4)


def test_serve_stops_on_sigterm():
    """One daemon process (``--device cpu``) exits 0 on SIGTERM, as a
    service manager stops it."""
    from libbicos_tpu_torch.client import BicosClient

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "libbicos_tpu_torch.serve", "--device", "cpu",
         "--port", str(port)], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        client = BicosClient(f"http://127.0.0.1:{port}", timeout=60)
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                assert client.healthz() == {"status": "ok", "compiled": 0}
                break
            except OSError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGTERM)
        ((rc, o, e),) = _finish([proc])
    assert rc == 0, f"{o}\n{e}"


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4], sys.argv[5], sys.argv[6], sys.argv[7:]))
