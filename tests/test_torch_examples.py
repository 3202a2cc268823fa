"""The port's examples (``examples/torch/``) run as real subprocesses on the
CPU (``--device cpu``) and print the invariants that
``tests/test_examples.py`` checks in the JAX ones; ``scale_out.py`` also
runs under ``torchrun`` with two gloo processes, loading its scene with
``io.load_multihost_stack``."""

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(script, *args, torchrun=0, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, str(REPO / "examples" / "torch" / script),
           "--device", "cpu", *args]
    if torchrun:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd[1:1] = ["-m", "torch.distributed.run", "--nproc-per-node",
                    str(torchrun), "--master-addr", "127.0.0.1",
                    "--master-port", str(port)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    return proc.stdout


def test_quickstart(tmp_path):
    out = _run("quickstart.py", str(tmp_path))
    assert "valid:" in out
    for artifact in ("disparity.png", "disparity.tiff", "corrmap.png",
                     "cloud.xyz"):
        assert (tmp_path / artifact).exists(), (artifact, out)
    err = float(out.split("max |err| on valid interior:")[1].split()[0])
    assert err <= 1.0, out


def test_scale_out():
    out = _run("scale_out.py")
    assert "over one device (cpu)" in out
    assert "sharded == single-device: True" in out
    assert "pair0 matches: True" in out
    assert "batched+sharded matches batched: True" in out
    agree = float(out.split("gt agreement ")[1].split("%")[0])
    assert agree >= 97.0, out


def test_scale_out_torchrun():
    out = _run("scale_out.py", "--scene", "10x40x96", torchrun=2)
    assert "mesh: 2 row bands of 20 rows over 2 processes" in out
    assert out.count("sharded == single-device: True") == 1  # rank 0 only
    assert "pair0 matches: True" in out
    assert "batched+sharded matches batched: True" in out


def test_serving():
    out = _run("serving.py")
    assert "daemon ready, 1 specialization(s) warm" in out
    assert "ground-truth agreement" in out
    agree = float(out.split("ground-truth agreement ")[1].split("%")[0])
    assert agree >= 97.0, out
    assert "specializations now warm: 2" in out
