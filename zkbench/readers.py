"""What the per-layer metrics read, each from one source: the device trace
of the window, the program's state and counters, or the host clock.  A
reading that finds nothing to read is None, and the metric is left out."""

from __future__ import annotations

from . import peaks, registry
from .trace import copy_or_set, kernel_base, port_kernel


def upload_pct(run):
    """Host-to-device copies' share of the window's device-busy time."""
    t = run.trace
    if t is None or not t.device:
        return None
    up = t.seconds_where(lambda n: "HtoD" in n)
    return 100.0 * up / t.busy_s if up else None


def torch_ops_pct(run):
    """The share of the device's summed event time in kernels that are
    neither the program's own (k_*) nor copies or memsets: the sorts,
    gathers, digit arithmetic and field glue of torch ops."""
    t = run.trace
    if t is None or not t.device:
        return None
    total = t.seconds_where(lambda n: True)
    other = t.seconds_where(
        lambda n: not port_kernel(n) and not copy_or_set(n))
    return 100.0 * other / total


def roofline_pct(run, kernel: str):
    """The least time of the kernel's work in the window (its counts, at
    the card's peaks) over its traced time, rescaled by CUDA events."""
    t = run.trace
    work = run.entry.kernel_work(kernel)
    if t is None or work is None:
        return None
    mod = registry.counts(kernel)
    seconds = t.seconds_where(lambda n: kernel_base(n) in mod.SYMBOLS)
    if not seconds:
        return None
    imad, n_bytes = mod.work(*work)
    return 100.0 * peaks.least_seconds(imad, n_bytes) / (seconds * t.scale)


def idle_pct(run):
    """1 - (union of the device events) / (the traced window)."""
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_mem_gb(run):
    """torch.cuda.max_memory_allocated over set-up and window, in GB."""
    return run.peak_bytes / 1e9 if run.peak_bytes else None


def init_s(run):
    """Host seconds of the program's init, synchronised."""
    return run.init_s
