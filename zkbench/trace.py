"""The device trace of a window: torch.profiler's raw events reduced to
what the per-layer metrics read.

The profiler has been seen to scale every device duration of a trace (by
0.673 and by 0.5) and to lose events, so its durations serve as shares;
where a metric needs a kernel's seconds, they are rescaled by CUDA events
recorded around the same window (`scale`).  Every time here is in seconds.
"""

from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass, field

import torch

WINDOW = "zkbench.window"


def kernel_base(name: str) -> str:
    """A device kernel's entry point as the trace names it, without its
    return type, anonymous namespace, template arguments and parameters:
    "(anonymous namespace)::k_gather_accumulate(unsigned int const*, ...)"
    gives "k_gather_accumulate"."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in "<(":
        name = name.split(cut, 1)[0]
    return name.strip()


def port_kernel(name: str) -> bool:
    """Whether a device kernel is one of the program's hand-written
    kernels: each is named k_* at file scope (csrc/*.cu); torch's live in
    namespaces."""
    base = kernel_base(name)
    return base.startswith("k_") and "::" not in base


def copy_or_set(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    """Device events (name, start, end) and host events (name, start, end)
    inside the window, on the profiler's clock; `window` its (start, end);
    `event_s` the CUDA-event time of the same window."""
    device: list
    host: list
    window: tuple
    event_s: float
    _union: list = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def union(self) -> list:
        """The device events' intervals merged, in order."""
        if self._union is None:
            merged = []
            for _, s, e in sorted(self.device, key=lambda d: d[1]):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._union = merged
        return self._union

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union())

    @property
    def scale(self) -> float:
        """CUDA-event seconds of the window over the span of its device
        events on the profiler's clock (1 where the profiler is sound)."""
        u = self.union()
        span = u[-1][1] - u[0][0] if u else 0.0
        return self.event_s / span if span > 0 else float("nan")

    def seconds_where(self, pick) -> float:
        """Summed durations of the device events whose name `pick` takes."""
        return sum(e - s for n, s, e in self.device if pick(n))

    def by_name(self) -> list:
        """[(name, seconds)] of the device events, longest first."""
        sums = {}
        for n, s, e in self.device:
            sums[n] = sums.get(n, 0.0) + e - s
        return sorted(sums.items(), key=lambda kv: -kv[1])

    def gaps(self) -> list:
        """[(start, end)] of the window's device idle time."""
        out, t = [], self.window[0]
        for s, e in self.union():
            if s > t:
                out.append((t, min(s, self.window[1])))
            t = max(t, e)
        if t < self.window[1]:
            out.append((t, self.window[1]))
        return [(s, e) for s, e in out if e > s]

    def idle_by_host(self) -> list:
        """[(what the host was doing, idle seconds)], longest first: each
        gap is named by the innermost host event running at its middle."""
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        sums, active, i = {}, [], 0
        for s, e in sorted(self.gaps()):
            mid = (s + e) / 2
            j = bisect.bisect_right(starts, mid)
            for name, hs, he in host[i:j]:
                heapq.heappush(active, (he - hs, he, name))
            i = max(i, j)
            while active and active[0][1] < mid:
                heapq.heappop(active)
            name = active[0][2] if active else "host code between torch ops"
            sums[name] = sums.get(name, 0.0) + e - s
        return sorted(sums.items(), key=lambda kv: -kv[1])


class Recorder:
    """torch.profiler around a window, with CUDA events at its ends."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        self._ev[0].record()
        self._span = record_function(WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._ev[1].record()
        self._ev[1].synchronize()
        self._prof.__exit__(*exc)
        return False

    def trace(self) -> Trace:
        from torch.autograd import DeviceType
        dev, host, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            s = e.start_ns() / 1e9
            end = s + e.duration_ns() / 1e9
            if name == WINDOW and e.device_type() != DeviceType.CUDA:
                window = (s, end)
            elif name.startswith("zkbench."):
                continue
            elif e.device_type() == DeviceType.CUDA:
                if e.duration_ns() > 0:
                    dev.append((name, s, end))
            else:
                host.append((name, s, end))
        if window is None:
            raise RuntimeError("the trace lacks the window's span")
        dev = [d for d in dev if d[2] > window[0] and d[1] < window[1]]
        host = [h for h in host if h[2] > window[0] and h[1] < window[1]]
        return Trace(dev, host, window,
                     self._ev[0].elapsed_time(self._ev[1]) / 1e3)
