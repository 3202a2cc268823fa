"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either. Module names are
compared by their top-level part, whole: ``libbicos_tpu_torch`` (the
port) begins with ``libbicos_tpu`` and is allowed in the harness."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "libbicos_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    # run.py and every file that a run loads by name.
    names = {kind: sorted(p.stem for p in (PB / kind).glob("*.py")
                          if p.stem != "__init__")
             for kind in ("entries", "metrics", "end_to_end", "reference")}
    code = ("import runpy\n"
            "runpy.run_path('portbench/run.py', run_name='portbench_run')\n"
            "from portbench import harness, spec, calibrate\n"
            f"for kind, names in {names!r}.items():\n"
            "    for n in names:\n"
            "        spec.load_module(kind, n)\n")
    loaded = _loaded(code)
    assert "libbicos_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & JAX, loaded & JAX


def test_reference_imports_neither_jax_nor_the_program():
    loaded = _loaded("import portbench.reference.bicos")
    assert not loaded & (JAX | {"libbicos_tpu_torch"})


def test_reference_sources_name_no_forbidden_module():
    for path in (PB / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in JAX | {"libbicos_tpu_torch"}, (
                    path, m)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "libbicos_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_x", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "libbicos_tpu.config", sys)
    assert set(harness.forbidden_modules()) == before | {"jax",
                                                         "libbicos_tpu"}
