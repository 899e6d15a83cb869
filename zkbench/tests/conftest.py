"""Fixtures of the benchmark's own tests.  Run them from the root of the
checkout:  python -m pytest zkbench/tests -q  (the `card` tests run only
where torch sees a CUDA card; they decide inside the test)."""

import json
import os
import shutil

import pytest

from zkbench import registry

# the cells shrunk to sizes the CPU's plain versions run in seconds
TINY = {"log_points": 6, "distinct_points": 16, "srs_log": 5,
        "log_coefficients": 5}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def write_tiny(root: str) -> str:
    """A checkout-shaped directory at `root` whose cells are the real ones
    at tiny sizes: BENCHMARK.json as it is, each config with TINY's sizes,
    each traffic mix with at most 2 vectors and 2 sets a call."""
    spec = registry.bench()
    os.makedirs(os.path.join(root, "zkbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "zkbench", "traffic"), exist_ok=True)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    for c in spec["configs"]:
        cfg = registry.config(spec, c["name"])
        cfg.update({k: v for k, v in TINY.items() if k in cfg})
        with open(os.path.join(root, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    for w in spec["workloads"]:
        t = registry.traffic(w["traffic"])
        t["vectors_per_call"] = min(2, t["vectors_per_call"])
        t["distinct_sets"] = min(2, t["distinct_sets"])
        t["warmup_calls"] = 1
        with open(os.path.join(root, "zkbench", "traffic",
                               f"{w['traffic']}.json"), "w") as fh:
            json.dump(t, fh)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return write_tiny(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def checkout_copy(tmp_path):
    """A copy of BENCHMARK.json and zkbench/ (no caches, no tests)."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(registry.PKG, root / "zkbench", ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    return root
