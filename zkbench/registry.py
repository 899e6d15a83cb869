"""Everything a run needs, found by the names in BENCHMARK.json: the cell,
its configuration file, its traffic file, the entry the traffic names,
each per-layer metric's reader and each kernel's counts."""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
import re

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "zkbench", "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def entry(name: str):
    """The module entries/<name>.py."""
    return importlib.import_module(f"zkbench.entries.{name}")


def counts(kernel: str):
    """The module counts/<kernel>.py."""
    return importlib.import_module(f"zkbench.counts.{kernel}")


def reader(metric: str, root: str = ROOT):
    """The reader of a per-layer metric: `read` of metrics/<metric>.py (a
    metric's name may hold dots) where that file exists; else, for
    `<kernel>_roofline`, the kernel's roofline share (its counts module
    must exist); else the function of readers.py named by the part of the
    name before the first dot (`idle_pct.msm` -> `readers.idle_pct`)."""
    path = os.path.join(root, "zkbench", "metrics", f"{metric}.py")
    if os.path.exists(path):
        name = "zkbench.metrics." + re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    from . import readers
    quantity = metric.split(".")[0]
    if quantity.endswith("_roofline"):
        kernel = quantity.removesuffix("_roofline")
        counts(kernel)
        return functools.partial(readers.roofline_pct, kernel=kernel)
    fn = getattr(readers, quantity, None)
    if (not callable(fn) or quantity.startswith("_")
            or fn is readers.roofline_pct
            or getattr(fn, "__module__", None) != readers.__name__):
        raise KeyError(f"no reader for metric {metric!r}")
    return fn


def metrics_of(spec: dict, workload: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports:
    those with no "workloads" key and those that list it."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]
