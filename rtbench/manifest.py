"""``BENCHMARK.json`` and the files it names.

A cell (one entry of ``workloads``) names a configuration and a traffic mix;
each is a data file found by its name (``configs`` gives the configuration's
file, ``rtbench/traffic/<mix>.json``), and the correctness limits of a cell
are ``rtbench/limits/<cell>.json``. A configuration's ``scene["mesh"]`` names
its scene kind, a builder file ``rtbench/scenes/<kind>.py`` with a function
``build(scene)`` that returns its triangles and spheres (``rtbench/scene.py``).
Every metric is a small reader of its own, ``rtbench/e2e/<name>.py`` or
``rtbench/metrics/<name>.py``, with a function ``read(ctx)`` that returns a
number, or None where it finds nothing to read. A later cell, configuration,
scene kind, mix or metric is a new file and a new entry: no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, cell_entry: dict, root: Path = ROOT) -> dict:
    entry = _by_name(manifest["configs"], cell_entry["config"], "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str) -> dict:
    with open(HERE / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def reports(metric: dict, cell_name: str) -> bool:
    """Whether a metric with a ``workloads`` key lists the cell; a metric
    without one is reported wherever its end-to-end metric is."""
    return cell_name in metric.get("workloads", [cell_name])


def cell_metrics(manifest: dict, cell_name: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries the cell reports: an
    end-to-end metric where its ``workloads`` list the cell (or it has none),
    a per-layer one where its list names the cell or, without a list, where
    the cell reports the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"] if reports(m, cell_name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def reader(kind: str, name: str):
    """The ``read`` function of ``rtbench/<kind>/<name>.py`` (kind ``e2e``
    or ``metrics``); the file's name is the metric's, dots included."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"rtbench.{kind}.{name.replace('.', '_')}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[mod_name] = mod
    return sys.modules[mod_name].read
