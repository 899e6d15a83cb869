"""Cells, configurations, traffic, entries and metrics are found by name,
and a new configuration, traffic mix and metric need new files and new
entries only."""

import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

from zkbench import registry

SPEC = registry.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the benchmark contract's limits on a run's length and on a bound
RUN_SECONDS = (1, 51)
BOUND = (0.01, 0.25)


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["zkbench"]
    assert RUN_SECONDS[0] <= SPEC["run_seconds"] <= RUN_SECONDS[1]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert BOUND[0] <= m["bound"] <= BOUND[1] and m["source"] in (
            "host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(workload):
    cell = registry.cell(SPEC, workload)
    cfg = registry.config(SPEC, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    entry = registry.entry(traffic["entry"])
    for attr in ("make_inputs", "init", "call", "release", "check",
                 "control", "plan", "kernel_work"):
        assert callable(getattr(entry.Entry, attr))
    assert cfg["name"] == cell["config"]
    listed = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert cfg["reduced"] == listed["reduced"]
    assert all(isinstance(k, str) and k in cfg for k in cfg["reduced"])
    e2e = registry.metrics_of(SPEC, workload, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = registry.metrics_of(SPEC, workload, "per_layer")
    assert layer
    for m in layer:
        assert callable(registry.reader(m["name"]))
        assert m["moves"] in {x["name"] for x in e2e}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]
                                    if m["name"].endswith("_roofline")])
def test_roofline_has_counts(metric):
    kernel = metric.removesuffix("_roofline")
    mod = registry.counts(kernel)
    assert mod.SYMBOLS and callable(mod.work)


@pytest.mark.parametrize("metric,want", [
    ("idle_pct.msm", "idle_pct"), ("idle_pct.any_new_split", "idle_pct"),
    ("init_s.commit", "init_s"), ("upload_pct.msm", "upload_pct"),
    ("te_gather_accumulate_roofline", "te_gather_accumulate"),
    ("sw_gather_accumulate_roofline", "sw_gather_accumulate")])
def test_shared_reader_by_name(metric, want):
    from zkbench import readers
    fn = registry.reader(metric)
    if metric.endswith("_roofline"):
        assert fn.func is readers.roofline_pct and fn.keywords == {
            "kernel": want}
    else:
        assert fn is getattr(readers, want)


@pytest.mark.parametrize("metric", ["no_such_quantity.msm", "peaks",
                                    "registry", "roofline_pct.msm",
                                    "_private.msm"])
def test_unknown_metric_has_no_reader(metric):
    with pytest.raises(KeyError):
        registry.reader(metric)


def test_unknown_kernel_roofline_has_no_reader():
    with pytest.raises(ImportError):
        registry.reader("no_such_kernel_roofline")


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_by_files_alone(checkout_copy):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    to a copy as new files and new entries of BENCHMARK.json are found by
    a fresh interpreter there; no file that was there changes but
    BENCHMARK.json, which gains entries only."""
    root = checkout_copy
    before = _digest(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "zkbench/configs/bls12-377-msm-2p26.json")
                     .read_text())
    cfg.update(name="bls12-377-msm-2p24", log_points=24)
    (root / "zkbench/configs/bls12-377-msm-2p24.json").write_text(
        json.dumps(cfg))
    (root / "zkbench/traffic/bits128.json").write_text(json.dumps(
        {"entry": "msm", "scalars": {"kind": "bits", "bits": 128},
         "vectors_per_call": 4, "distinct_sets": 1}))
    (root / "zkbench/metrics/calls_per_s.msm.py").write_text(
        "def read(run):\n    return len(run.latencies) / run.window_s\n")
    spec["configs"].append({"name": "bls12-377-msm-2p24", "source": "x",
                            "file": "zkbench/configs/bls12-377-msm-2p24.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "msm-2p24-bits128",
                              "config": "bls12-377-msm-2p24",
                              "traffic": "bits128", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls_per_s.msm", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "MSM API", "moves": "msm_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    probe = (
        "from types import SimpleNamespace as N\n"
        "from zkbench import registry as r\n"
        "s = r.bench()\n"
        "c = r.cell(s, 'msm-2p24-bits128')\n"
        "cfg = r.config(s, c['config'])\n"
        "t = r.traffic(c['traffic'])\n"
        "e = r.entry(t['entry']).Entry(cfg, t, 1, None)\n"
        "names = [m['name'] for m in r.metrics_of(s, c['name'], 'per_layer')]\n"
        "run = N(latencies=[1, 1], window_s=4.0)\n"
        "print(cfg['log_points'], e.n, t['scalars']['bits'], "
        "'calls_per_s.msm' in names, r.reader('calls_per_s.msm')(run))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["24", str(1 << 24), "128", "True", "0.5"]
    after = _digest(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}
