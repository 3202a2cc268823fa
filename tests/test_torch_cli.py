"""The port's CLI (``python -m libbicos_tpu_torch.cli``) against the JAX
package's (``python -m libbicos_tpu.cli``), on the CPU: the same
``Config`` for every argv, the same stdout/stderr lines apart from the
latencies, the same disparity files (TIFF, PNG, ``.xyz``, descriptor
dump), the corrmap TIFF within CORR_TOL, the same exit code and message
for a missing folder; ``--devices 2`` over two gloo processes writes,
from rank 0 only, the files of the single-process run."""

import os
import re
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from libbicos_tpu import cli as jcli

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import cli as tcli
from libbicos_tpu_torch.io import synthetic_stack_pair

REPO = Path(__file__).resolve().parent.parent
CORR_TOL = dict(rtol=4e-6, atol=4e-6)

ARGVS = [
    [],
    ["-t", "0.5", "--limited"],
    ["-t", "0", "--corrmap"],
    ["-t", "-2"],
    ["--corrmap", "-s", "0.1", "-v", "2.0"],
    ["-v", "0"],
    ["-v", "-1.5", "-t", "0.9"],
    ["-m", "1"],
    ["-m", "3", "--no-dupes", "--double"],
    ["--no-dupes"],
    ["--disp-range=-5:40", "--limited"],
    ["-n", "4", "-q", "Q.yaml", "--allow-negative-z", "-o", "x/y.png"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=" ".join)
def test_config_from_args_matches(argv, capsys):
    jargs = jcli.build_parser().parse_args(["folder", *argv])
    want = jcli.config_from_args(jargs)
    want_err = capsys.readouterr().err
    targs = tcli.build_parser().parse_args(["folder", *argv])
    got = tcli.config_from_args(targs)
    assert got == tb.config_from_reference(want)
    assert capsys.readouterr().err == want_err
    shared = vars(jargs).keys() & vars(targs).keys()
    assert {k: vars(targs)[k] for k in shared} == {
        k: vars(jargs)[k] for k in shared}


@pytest.mark.parametrize("argv", [["-m", "-1"], ["-n", "-2"],
                                  ["--disp-range", "5:1"],
                                  ["--disp-range", "a:b"]])
def test_bad_arguments_exit_alike(argv, capsys):
    for mod in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            mod.config_from_args(mod.build_parser().parse_args(
                ["folder", *argv]))
        capsys.readouterr()
        if mod is jcli:
            want = str(e.value)
        else:
            assert str(e.value) == want


def test_parsers_share_the_reference_flags():
    def flags(parser):
        return {a.dest: (a.option_strings, a.default)
                for a in parser._actions}

    jf, tf = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert {k: v for k, v in tf.items() if k != "device"} == {
        k: v for k, v in jf.items()}
    assert tcli.build_parser()._option_string_actions[
        "--backend"].choices == ["auto", "cuda", "torch"]
    assert tcli.LICENSE_HEADER == jcli.LICENSE_HEADER


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """n=6 u8 stacks of 10 x 48 (single-folder layout) and a Q matrix."""
    d = tmp_path_factory.mktemp("cli")
    s0, s1, _ = synthetic_stack_pair(6, 10, 48, seed=21)
    (d / "imgs").mkdir()
    for i in range(6):
        cv2.imwrite(str(d / "imgs" / f"{i}_left.png"), s0[i])
        cv2.imwrite(str(d / "imgs" / f"{i}_right.png"), s1[i])
    fs = cv2.FileStorage(str(d / "Q.yaml"), cv2.FILE_STORAGE_WRITE)
    fs.write("Q", np.array([[1, 0, 0, -24.0], [0, 1, 0, -5.0],
                            [0, 0, 0, 120.0], [0, 0, 1 / 0.1, 0]]))
    fs.release()
    return d


def _run(module, args, cwd, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


_LATENCY = re.compile(r"[0-9.]+ms")


def _lines(text, tag):
    return [_LATENCY.sub("Tms", line).replace(f"{tag}/", "OUT/")
            for line in text.splitlines()]


CLI_CASES = {
    "headline": ["-t", "0.5", "--limited", "--corrmap", "-s", "0.1", "-v",
                 "2.0", "-q", "../Q.yaml"],
    "consistency": ["-m", "1", "--no-dupes", "--limited", "-t", "0.6",
                    "--corrmap"],
    "defaults full": ["-q", "../Q.yaml", "--allow-negative-z",
                      "--dump-descriptors", "OUT/desc.npz"],
    "no threshold": ["-t", "0", "--limited", "--disp-range", "0:20", "-n",
                     "5", "--dump-descriptors", "OUT/desc.npz"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_end_to_end_matches_jax(folder, case):
    outs = {}
    for tag, module, extra in (("j", "libbicos_tpu.cli", []),
                               ("t", "libbicos_tpu_torch.cli",
                                ["--device", "cpu"])):
        wd = folder / f"{case.replace(' ', '_')}_{tag}"
        wd.mkdir()
        args = [a.replace("OUT/", f"{tag}/") for a in CLI_CASES[case]]
        (wd / tag).mkdir()
        proc = _run(module, ["../imgs", *args, "-o", f"{tag}/disp.png",
                             *extra], wd, {"BICOS_DEBUG": "1"})
        assert proc.returncode == 0, proc.stderr
        outs[tag] = (wd / tag, proc)
    (jd, jp), (td, tp) = outs["j"], outs["t"]
    assert _lines(tp.stdout, "t") == _lines(jp.stdout, "j")
    assert _lines(tp.stderr, "t") == _lines(jp.stderr, "j")
    names = sorted(p.name for p in jd.iterdir())
    assert sorted(p.name for p in td.iterdir()) == names
    for name in names:
        if name == "disp-corrmap.tiff":
            a, b = (cv2.imread(str(d / name), cv2.IMREAD_UNCHANGED)
                    for d in (td, jd))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            m = ~np.isnan(b)
            np.testing.assert_allclose(a[m], b[m], **CORR_TOL)
        elif name == "desc.npz":
            a, b = np.load(td / name), np.load(jd / name)
            assert sorted(a.files) == sorted(b.files) == ["words0", "words1"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype == np.uint32
                np.testing.assert_array_equal(a[k], b[k])
        elif name != "disp-corrmap.png":  # colours of corrmaps within tol
            assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    assert "disp.tiff" in names


def test_cli_missing_folder_exits_alike(tmp_path):
    procs = [_run(module, [str(tmp_path / "nope"), *extra], tmp_path)
             for module, extra in (("libbicos_tpu.cli", []),
                                   ("libbicos_tpu_torch.cli",
                                    ["--device", "cpu"]))]
    assert [p.returncode for p in procs] == [2, 2]
    assert procs[1].stderr == procs[0].stderr
    assert "bicos: error:" in procs[1].stderr and "nope" in procs[1].stderr
    assert procs[1].stdout == procs[0].stdout


def test_cli_without_torch_distributed_names_torchrun(folder, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        tcli.main([str(folder / "imgs"), "--devices", "2", "--device",
                   "cpu"])


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_cli_devices_two_gloo_processes(folder, tmp_path, axis):
    """Two gloo workers (``tests/test_torch_dist.py``'s harness) run the
    CLI with ``--devices 2``: rank 0 writes the files of the single-process
    run, byte for byte, and rank 1 prints and writes nothing."""
    from test_torch_dist import start_group

    args = ["-t", "0.5", "--limited", "--corrmap", "-s", "0.25", "-q",
            str(folder / "Q.yaml"), "--shard-axis", axis]
    single = tmp_path / "single"
    single.mkdir()
    assert tcli.main([str(folder / "imgs"), *args, "-o",
                      str(single / "d.png"), "--device", "cpu"]) == 0
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    procs = start_group(tmp_path, 2, tmp_path / "unused.npz", "gloo",
                        [str(folder / "imgs"), *args, "-o",
                         str(sharded / "d.png")])
    assert "Saved pointcloud" in procs[0].stdout
    assert procs[1].stdout == "" and procs[1].stderr == ""
    names = sorted(p.name for p in single.iterdir())
    assert sorted(p.name for p in sharded.iterdir()) == names
    for name in names:
        assert (sharded / name).read_bytes() == (single / name).read_bytes()
