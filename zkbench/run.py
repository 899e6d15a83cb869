"""Run one cell of the benchmark once and print its result line.

    python3 -m zkbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the start of this process): the inputs
drawn from the seed, the program's kernels built (only the first run in a
checkout compiles), the program's init and warm-up calls.  Then the
window: calls back to back, one caller, for --seconds (a call is started
only while the window has room for it).  With --trace 1 the window runs
under torch.profiler, for at most TRACE_SECONDS, and the line carries
the per-layer metrics;
with --trace 0 the end-to-end ones.  After the window the program's state
is freed and the outputs are held against the plain reference.  The last
line of standard output is one JSON object; the numbers compared, each
with its limit, end standard error and the line's "checks".
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402

from . import registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "zprize_tpu")
# a traced window lasts at most this long: the profiler's host overhead and
# the reading of its events grow with the window, and the per-layer
# metrics are shares, which a shorter window gives as well
TRACE_SECONDS = 10.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_env(root: str) -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    library may load JAX."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclass
class Run:
    """What the per-layer readers read."""
    entry: object
    init_s: float
    latencies: list = field(default_factory=list)
    units: int = 0
    window_s: float = 0.0
    peak_bytes: int = 0
    trace: object = None
    launches: dict = field(default_factory=dict)


def launch_counts() -> dict:
    from zprize_tpu_torch.msm import accum_kernel
    from zprize_tpu_torch.ntt import fr_kernel, gl_kernel
    return {**accum_kernel.launches, **fr_kernel.launches,
            **gl_kernel.launches}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def host_line() -> str:
    """The host's CPU model, cores and load, beside every run's numbers."""
    model = "cpu model unknown"
    try:
        with open("/proc/cpuinfo") as fh:
            model = next(line.split(":", 1)[1].strip() for line in fh
                         if line.startswith("model name"))
    except (OSError, StopIteration):
        pass
    load = ", ".join(f"{x:.2f}" for x in os.getloadavg())
    return f"{model}, {os.cpu_count()} cores, load {load}"


def window(entry, seconds: float, run: Run) -> None:
    """Calls back to back while the window has room for one more."""
    start = time.perf_counter()
    end = start
    while True:
        t = time.perf_counter()
        run.units += entry.call()
        end = time.perf_counter()
        run.latencies.append(end - t)
        mean = (end - start) / len(run.latencies)
        if end - start + mean > seconds:
            break
    run.window_s = end - start


def end_to_end(spec, workload, run, setup_s, unit) -> dict:
    out = {}
    for m in registry.metrics_of(spec, workload, "end_to_end"):
        name = m["name"]
        if name == "setup_s":
            value = setup_s
        elif name == f"{unit}_ms":
            value = 1e3 * run.window_s / run.units
        elif name == f"{unit}_p95_ms":
            value = 1e3 * float(np.percentile(run.latencies, 95))
        else:
            raise KeyError(f"no rule for end-to-end metric {name!r}")
        out[name] = {"value": value, "unit": m["unit"]}
    return out


def per_layer(spec, workload, run, root) -> dict:
    out = {}
    for m in registry.metrics_of(spec, workload, "per_layer"):
        value = registry.reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device, root: str = registry.ROOT) -> dict:
    """One run of the cell on `device`; returns the result line's object."""
    import torch
    spec = registry.bench(root)
    cell = registry.cell(spec, workload)
    config = registry.config(spec, cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root)
    entry = registry.entry(traffic["entry"]).Entry(config, traffic, seed,
                                                   device)
    on_card = device.type == "cuda"
    t = time.perf_counter()
    entry.make_inputs()
    log(f"inputs drawn in {time.perf_counter() - t:.3f} s")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        from zprize_tpu_torch.utils import build
        t = time.perf_counter()
        built = build.build_all()
        log(f"build {time.perf_counter() - t:.3f} s "
            f"({', '.join(built) or 'all current'})")
    run = Run(entry, entry.init())
    log(f"init {run.init_s:.3f} s, plan {entry.plan()}")
    for _ in range(int(traffic.get("warmup_calls", 1))):
        t = time.perf_counter()
        entry.call()
        log(f"warm-up call {time.perf_counter() - t:.4f} s")
    entry.outputs.clear()
    setup_s = time.perf_counter() - T0
    if on_card:
        before = launch_counts()
    if trace:
        from .trace import Recorder
        with Recorder() as rec:
            window(entry, min(seconds, TRACE_SECONDS), run)
        run.trace = rec.trace()
    else:
        window(entry, seconds, run)
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated()
        after = launch_counts()
        run.launches = {k: (after[k] - before[k]) / len(run.latencies)
                        for k in after if after[k] > before[k]}
    log(f"window {run.window_s:.4f} s: {len(run.latencies)} calls, "
        f"{run.units} {entry.unit}s; call s min/median/max "
        f"{min(run.latencies):.4f} / {np.median(run.latencies):.4f} / "
        f"{max(run.latencies):.4f}")
    if trace:
        log(f"launches per call: {run.launches}")
        t = run.trace
        log(f"trace: {len(t.device)} device events, busy {t.busy_s:.4f} s "
            f"of {t.window_s:.4f} s, CUDA-event scale {t.scale:.4f}")
    metrics = (per_layer(spec, workload, run, root) if trace
               else end_to_end(spec, workload, run, setup_s, entry.unit))
    entry.release()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = entry.check()
    log(f"reference check {time.perf_counter() - t:.3f} s")
    wrong = sum(v for v, _ in checks.values())
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": run.units,
        "failed": min(run.units, wrong),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else device.type),
                   "count": 1,
                   "memory_peak_bytes": run.peak_bytes},
    }
    if trace:
        tr = run.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in tr.by_name()[:10]],
            "idle_gaps": [[n[:120], s] for n, s in tr.idle_by_host()[:10]]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(registry.ROOT)
    import torch
    cell = registry.cell(registry.bench(), args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; host: {host_line()}")
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda"))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"modules that must not load were loaded: {loaded}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
