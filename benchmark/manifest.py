"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; a configuration's file is
named in the manifest, a mix is ``traffic/<mix>.json``, each metric is
read by ``metrics/<metric>.py`` (a ``read(run)`` function returning a
number or None) and a configuration's plain reference is
``references/<reference>.py``. Adding a cell, a mix, a metric or a
configuration adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for c in manifest["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The metric's reader module, ``metrics/<metric>.py``."""
    safe = metric.replace(".", "_").replace("-", "_")
    return _load_module(HERE / "metrics" / f"{metric}.py",
                        f"benchmark_metric_{safe}")


def reference(name: str):
    """A configuration's plain reference, ``references/<name>.py``."""
    return _load_module(HERE / "references" / f"{name}.py",
                        f"benchmark_reference_{name}")


def metrics_for(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones in an
    untraced run, the per-layer ones in a traced run; a metric with a
    ``workloads`` list only in those cells."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]
