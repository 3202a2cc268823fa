"""What the benchmark runs, found by name.

``BENCHMARK.json`` at the root of a checkout names every cell, with its
configuration and its traffic mix, and every metric. Each name leads to
files of its own under ``portbench/``:

* ``configs/<config>.json``: the configuration as it is run (sizes,
  settings, its source, what was assumed and reduced) and the name of its
  plain reference, ``reference/<reference>.py``;
* ``traffic/<traffic>.json``: the parameters of the input generator and of
  the loop that offers the pairs, and the entry kind,
  ``entries/<entry>.py``;
* ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: the readers of
  the end-to-end and per-layer metrics.

A later change adds a configuration, a traffic mix, a cell, an entry kind
or a metric as new files and ``BENCHMARK.json`` entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"portbench: {path} is missing")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {kind} file {path}")
    mod_name = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Benchmark:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.data["workloads"])
        raise KeyError(f"portbench: no workload {name!r} (known: {known})")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"portbench: no configuration {name!r}")

    @staticmethod
    def traffic(name: str) -> dict:
        return _json(HERE / "traffic" / f"{name}.json")

    @staticmethod
    def limits(cell: str) -> dict:
        return _json(HERE / "workloads" / f"{cell}.json")["limits"]

    def metrics(self, section: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.data[section]
                if cell in m.get("workloads", [cell])]


def port_config(cfg: dict):
    """The program's ``Config`` for a configuration file."""
    from libbicos_tpu_torch.config import (Config, Consistency,
                                           NoDuplicates, Precision,
                                           TransformMode)

    v = cfg["variant"]
    if v["kind"] == "Consistency":
        variant = Consistency(max_lr_diff=int(v["max_lr_diff"]),
                              no_dupes=bool(v.get("no_dupes", False)))
    elif v["kind"] == "NoDuplicates":
        variant = NoDuplicates()
    else:
        raise ValueError(f"unknown search variant {v['kind']!r}")
    drange = cfg.get("disparity_range")
    return Config(nxcorr_threshold=cfg["nxcorr_threshold"],
                  subpixel_step=cfg.get("subpixel_step"),
                  min_variance=cfg.get("min_variance"),
                  mode=TransformMode[cfg["mode"]],
                  precision=Precision[cfg["precision"]],
                  variant=variant,
                  disparity_range=None if drange is None else tuple(drange))
