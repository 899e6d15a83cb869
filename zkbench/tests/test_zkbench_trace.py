"""The trace reductions and the per-layer readers on hand-made events."""

from types import SimpleNamespace

import pytest

from zkbench import readers
from zkbench.trace import Trace, kernel_base, port_kernel

DEV = [("Memcpy HtoD (Pageable -> Device)", 0.0, 1.0),
       ("(anonymous namespace)::k_gather_accumulate(unsigned int const*, long)", 1.0, 4.0),
       ("void at::native::sort_kernel(int)", 5.0, 6.0),
       ("void k_tree_segment(int*)", 6.0, 6.5)]
HOST = [("aten::sort", 4.0, 6.0), ("cudaStreamSynchronize", 4.2, 4.9),
        ("aten::item", 6.5, 8.0)]


def _trace(event_s=8.0):
    return Trace(list(DEV), list(HOST), (0.0, 8.0), event_s)


def test_union_busy_gaps_scale():
    t = _trace()
    assert t.union() == [[0.0, 4.0], [5.0, 6.5]]
    assert t.busy_s == pytest.approx(5.5)
    assert t.gaps() == [(4.0, 5.0), (6.5, 8.0)]
    assert t.scale == pytest.approx(8.0 / 6.5)
    assert t.by_name()[0] == (
        "(anonymous namespace)::k_gather_accumulate(unsigned int const*, long)",
        3.0)


def test_idle_named_by_innermost_host_event():
    # the gap 4..5 has its middle (4.5) inside cudaStreamSynchronize,
    # which lies inside aten::sort; the gap 6.5..8 inside aten::item
    assert dict(_trace().idle_by_host()) == pytest.approx(
        {"cudaStreamSynchronize": 1.0, "aten::item": 1.5})


def test_readers_shares():
    run = SimpleNamespace(trace=_trace(), peak_bytes=2e9, init_s=3.0)
    assert readers.idle_pct(run) == pytest.approx(100 * 2.5 / 8)
    assert readers.upload_pct(run) == pytest.approx(100 / 5.5)
    assert readers.torch_ops_pct(run) == pytest.approx(100 / 5.5)
    assert readers.peak_mem_gb(run) == 2.0 and readers.init_s(run) == 3.0
    empty = SimpleNamespace(trace=None)
    assert readers.idle_pct(empty) is None
    assert readers.upload_pct(empty) is None


def test_roofline_rescaled_by_cuda_events():
    rows, lanes = 10**9, 0
    entry = SimpleNamespace(kernel_work=lambda k: (rows, lanes)
                            if k == "te_gather_accumulate" else None)
    # profiler span 6.5 s, CUDA events 6.5 s: the kernel's 3 s stand
    run = SimpleNamespace(trace=_trace(6.5), entry=entry)
    least = max(rows * 7 * 588 / 16.75e12, rows * 156 / 3.35e12)
    assert readers.roofline_pct(run, "te_gather_accumulate") == pytest.approx(
        100 * least / 3.0)
    # a profiler that ran slow by half: its 3 s were 1.5 s on the card
    run = SimpleNamespace(trace=_trace(6.5 / 2), entry=entry)
    assert readers.roofline_pct(run, "te_gather_accumulate") == pytest.approx(
        100 * least / 1.5)
    # no work reported, or no such kernel traced: nothing to read
    assert readers.roofline_pct(run, "te_bucket_accumulate") is None
    assert kernel_base("void k_sw_gather_accumulate<3>(a)") == (
        "k_sw_gather_accumulate")
    assert port_kernel("(anonymous namespace)::k_tree_finish(int*)")
    assert not port_kernel("void at::native::k_thing(int)")
