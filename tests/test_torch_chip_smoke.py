"""chip_smoke.py's profiler window on the CPU: a trace that keeps fewer
device events than the window launched is profiled again with the next,
wider margin, and the result says how many attempts it took and whether
its trace was complete.  The profiler, the clock and the launch counters
are stand-ins: the real trace exists only on the card."""

import contextlib
import importlib.util
import pathlib

import pytest
import torch

from torch_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("traced_by_attempt, attempts, complete", [
    ((16,), 1, True),
    ((15, 16), 2, True),
    ((0, 15, 15, 16), 4, True),
    ((15, 15, 15, 15), 4, False),
])
def test_profile_call_widens_its_margin_until_the_trace_is_whole(
        monkeypatch, traced_by_attempt, attempts, complete):
    cs = _chip_smoke()
    counts = {"gl_ntt": 0}
    traced = iter(traced_by_attempt)
    slept = []

    @contextlib.contextmanager
    def profile(activities):
        yield object()

    def fn():
        counts["gl_ntt"] += 16

    def device_kernels(prof):
        n = next(traced)
        return [(5.5 * n / 16, n, "k_gl_ntt<12>")] if n else []

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs.time, "sleep", slept.append)
    monkeypatch.setattr(cs, "port_launches", lambda: dict(counts))
    monkeypatch.setattr(cs, "device_kernels", device_kernels)
    monkeypatch.setattr(cs, "device_span_ms", lambda prof: [0.0, 1.0])
    monkeypatch.setattr(cs, "log", lambda msg: None)
    out = cs.profile_call("chain", fn)
    margins = cs.TRACE_MARGINS_S[:attempts]
    assert slept == [m for m in margins for _ in range(2)]
    assert margins == tuple(sorted(set(margins)))
    assert out["attempts"] == attempts and out["margin_s"] == margins[-1]
    assert out["complete"] is complete
    assert out["launched"] == {"gl_ntt": 16}
    assert out["traced"] == {"gl_ntt": traced_by_attempt[-1]}
    assert [a["margin_s"] for a in out["short_attempts"]] == \
        list(margins[:attempts - complete])
    assert out["other_kernels"] == []
    if not complete:
        assert out["device_idle_share"] == "not measured"
