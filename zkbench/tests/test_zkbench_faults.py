"""A run of each cell at tiny sizes on the CPU (the harness's look for a
card skipped), sound and with the timed path broken underneath: the
sound run is correct; the control, and each fault the cell can have, are
not.  The faults: an answer altered where it is produced; half of the
batch left out; the work skipped (the identity returned); a call that
returns the state of an earlier call (where calls differ); in the MSM
cells, on their own m = 1 route, a table row read in another's place
(row i as row i mod n/2, an index cut by one bit)."""

import functools

import pytest
import torch

from zkbench import control, registry, run

SEED = 2**31 + 11
CELLS = [w["name"] for w in registry.bench()["workloads"]]


def _alter(point):
    x = point.x.clone()
    x.view(-1)[0] ^= 1
    return type(point)(x, point.y, point.z)


def _identity(point):
    z = torch.zeros_like(point.z)
    return type(point)(torch.zeros_like(point.x), point.y, z)


def _patch_msm(monkeypatch, fault):
    from zprize_tpu_torch.msm import pippenger
    orig = pippenger.msm

    @functools.wraps(orig)
    def broken(curve, points, scalars, *a, **k):
        if fault == "half":
            scalars = scalars.clone()
            scalars[scalars.shape[0] // 2:] = 0
        out = orig(curve, points, scalars, *a, **k)
        return {"altered": _alter, "skipped": _identity}.get(
            fault, lambda p: p)(out)
    monkeypatch.setattr(pippenger, "msm", broken)


def _patch_batch(monkeypatch, fault):
    from zprize_tpu_torch.msm import pippenger
    orig = pippenger.msm_jit_batch

    @functools.wraps(orig)
    def broken(curve, points, scalars, *a, **k):
        if fault == "half":
            scalars = scalars.clone()
            scalars[scalars.shape[0] // 2:] = 0
        out = orig(curve, points, scalars, *a, **k)
        return {"altered": _alter, "skipped": _identity}.get(
            fault, lambda p: p)(out)
    monkeypatch.setattr(pippenger, "msm_jit_batch", broken)


def _patch_stale(monkeypatch):
    from zprize_tpu_torch.pcs import kzg
    orig, first = kzg.commit, []

    def stale(srs, coeffs, *a, **k):
        if not first:
            first.append(orig(srs, coeffs, *a, **k))
        return first[0]
    monkeypatch.setattr(kzg, "commit", stale)


def _m1_route(monkeypatch):
    """The MSM cells' own route at any size: the m = 1 table, whose rows
    `te_gather_accumulate` reads through the sort permutation (at 2^26
    the plan is m = 1 by itself; at the tests' sizes it is collapsed)."""
    from zprize_tpu_torch.msm import api
    monkeypatch.setattr(api, "multi_scalar_mult_init", functools.partial(
        api.multi_scalar_mult_init, collapse=False))


def _patch_remap(monkeypatch):
    from zprize_tpu_torch.msm import pippenger
    orig, calls = pippenger.te_gather_accumulate, []

    def remapped(curve, table, perm, *a):
        calls.append(table.shape[0])
        return orig(curve, table, perm % (table.shape[0] // 2), *a)
    monkeypatch.setattr(pippenger, "te_gather_accumulate", remapped)
    return calls


MSM_CELLS = ["msm-2p26-uniform", "msm-2p26-u64"]
FAULTS = [("msm-2p26-uniform", f) for f in ("altered", "half", "skipped")]
FAULTS += [("kzg-2p20-commit", f)
           for f in ("altered", "half", "skipped", "stale")]
FAULTS += [("kzg-2p20-batch8", f) for f in ("altered", "half", "skipped")]


def _execute(workload, root):
    return run.execute(workload, SEED, 0.0, False, torch.device("cpu"), root)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, tiny_root):
    r = _execute(workload, tiny_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert set(r["metrics"]) == {m["name"] for m in registry.metrics_of(
        registry.bench(), workload, "end_to_end")}


@pytest.mark.parametrize("workload", MSM_CELLS)
def test_sound_run_on_the_m1_route_is_correct(workload, tiny_root,
                                              monkeypatch):
    _m1_route(monkeypatch)
    r = _execute(workload, tiny_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("workload", MSM_CELLS)
def test_row_read_in_another_place_is_not_correct(workload, tiny_root,
                                                  monkeypatch):
    _m1_route(monkeypatch)
    calls = _patch_remap(monkeypatch)
    r = _execute(workload, tiny_root)
    assert calls and set(calls) == {1 << 6}
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault, tiny_root, monkeypatch):
    if fault == "stale":
        _patch_stale(monkeypatch)
    elif workload == "kzg-2p20-batch8":
        _patch_batch(monkeypatch, fault)
    else:
        _patch_msm(monkeypatch, fault)
    r = _execute(workload, tiny_root)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, tiny_root):
    checks = control.readings(workload, SEED, torch.device("cpu"), tiny_root)
    assert all(v > lim for v, lim in checks.values())
