"""The port stands alone: every module imports with jax blocked, no source
names jax or the reference package, and without a card the default-device
entry points (the MSM's on both routes, the test SRS's on both curves, the
NTT domain's, the Poseidon sponge's, the Goldilocks NTT's and the
converters') and chip_smoke.py refuse to run."""

import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from zprize_tpu_torch import convert
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
from zprize_tpu_torch.hash import poseidon
from zprize_tpu_torch.hash.grain import snarkvm_config
from zprize_tpu_torch.msm import api
from zprize_tpu_torch.ntt import gl_kernel
from zprize_tpu_torch.ntt.domain import Domain
from zprize_tpu_torch.pcs import kzg
from zprize_tpu_torch.utils import device
from torch_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "zprize_tpu_torch"


def _python(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_with_jax_blocked():
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "sys.modules['jax'] = None",
        "sys.modules['jaxlib'] = None",
        "import zprize_tpu_torch",
        "names = [m.name for m in pkgutil.walk_packages(",
        "    zprize_tpu_torch.__path__, 'zprize_tpu_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "ref = [m for m in sys.modules",
        "       if m == 'zprize_tpu' or m.startswith('zprize_tpu.')]",
        "assert not ref, ref",
        "print(len(names))",
    ])
    r = _python(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 41     # 31 modules, 10 subpackages


def test_sources_name_neither_jax_nor_the_reference_package():
    files = [p for p in PKG.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 49     # 41 modules, 7 CUDA sources, chip_smoke
    for path in files:
        text = path.read_text()
        assert "zprize_tpu." not in text, path
        assert "jax" not in text.lower(), path


@pytest.mark.parametrize("entry", ["msm_init", "msm_init_bls12_381",
                                   "test_srs", "test_srs_bls12_381",
                                   "domain", "sponge", "gl_ntt"])
def test_default_device_entry_point_requires_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry.startswith("msm_init"):
            curve = BLS12_381_G1 if entry.endswith("381") else BLS12_377_G1
            api.multi_scalar_mult_init(curve, [(curve.gen_x, curve.gen_y)])
        elif entry.startswith("test_srs"):
            curve = BLS12_381_G1 if entry.endswith("381") else BLS12_377_G1
            kzg.setup_test_srs(curve, 4)
        elif entry == "domain":
            Domain(BLS12_377_G1.scalar, 3)
        elif entry == "sponge":
            poseidon.Sponge(snarkvm_config(BLS12_377_G1.scalar, 2))
        else:
            gl_kernel.ntt_fourstep_packed(2, 2, torch.zeros(16,
                                                            dtype=torch.int64))


_PLANES = np.zeros((2, BLS12_377_G1.field.n_limbs), np.uint32)
_CONVERTERS = {
    "elements": lambda: convert.elements_from_reference(BLS12_377_G1.field,
                                                        _PLANES),
    "points": lambda: convert.points_from_reference(
        BLS12_377_G1, _PLANES, _PLANES, [True, True]),
    "scalars": lambda: convert.scalars_from_reference(
        BLS12_377_G1, np.zeros((2, 17), np.uint16)),
    "prepared": lambda: convert.prepared_from_reference(
        BLS12_377_G1, np.zeros((39, 2), np.uint32), 8, 1, 1, 2),
    "gl": lambda: convert.gl_from_reference(np.zeros(2, np.uint32),
                                            np.zeros(2, np.uint32)),
    "fr": lambda: convert.fr_from_reference(BLS12_377_G1,
                                            np.zeros((2, 17), np.uint32)),
    "srs": lambda: convert.srs_from_reference(types.SimpleNamespace(
        curve=BLS12_377_G1, g1_powers=types.SimpleNamespace(
            x=_PLANES, y=_PLANES, inf=[True, True]),
        h=None, tau_h=None, tau=None)),
}


@pytest.mark.parametrize("name", sorted(_CONVERTERS))
def test_converters_require_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _CONVERTERS[name]()


@pytest.mark.parametrize("devices, expect", [
    (("cpu",), False), (("cpu", "cpu"), False),
    (("meta",), ValueError), (("cpu", "meta"), ValueError)],
    ids=["cpu", "cpu pair", "meta", "mixed"])
def test_wrappers_dispatch_on_their_tensors_device(devices, expect):
    """The kernel wrappers' one dispatch test: CPU tensors take the plain
    version, any other device but the card raises, and so do tensors on
    several devices."""
    tensors = [torch.zeros(2, device=d) for d in devices]
    if expect is ValueError:
        with pytest.raises(ValueError):
            device.on_card(*tensors)
    else:
        assert device.on_card(*tensors) is expect


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    r = _python(["chip_smoke.py"], ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _python(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
