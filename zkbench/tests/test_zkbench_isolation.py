"""A run loads no JAX and no module of the JAX package, and the command
refuses to run without a card."""

import os
import subprocess
import sys

import pytest

from zkbench import registry

PROBE = """
import sys, torch
from zkbench import control, run
run.execute("msm-2p26-uniform", 5, 0.0, False, torch.device("cpu"), {root!r})
run.execute("kzg-2p20-batch8", 5, 0.0, False, torch.device("cpu"), {root!r})
import zkbench.entries.kzg_commit, zkbench.trace, zkbench.readers
for m in registry_metrics():
    pass
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_run_loads_no_jax(tiny_root):
    code = PROBE.format(root=tiny_root).replace(
        "for m in registry_metrics():\n    pass\n",
        "from zkbench import registry\n"
        "[registry.reader(m['name']) for m in registry.bench()['per_layer']]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "zprize_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "zprize_tpu"}


def test_no_card_no_result():
    if _has_card():
        pytest.skip("a card is present: this checks the run without one")
    out = subprocess.run([sys.executable, "-m", "zkbench.run", "--workload",
                          "msm-2p26-uniform", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def _has_card():
    import torch
    return torch.cuda.is_available()


@pytest.mark.card
def test_bare_checkout_fails(tmp_path):
    """With only BENCHMARK.json and zkbench/ the command fails and prints
    no result (the program is not there)."""
    if not _has_card():
        pytest.skip("needs a CUDA card")
    import shutil
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.PKG, tmp_path / "zkbench")
    out = subprocess.run([sys.executable, "-m", "zkbench.run", "--workload",
                          "kzg-2p20-commit", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
