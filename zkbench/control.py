"""The control of a cell's check: the plain reference put in the
program's place with one guarantee broken (each scalar's or coefficient
value's 16 low bits cleared), judged by the same comparison.  It has to
come out as not correct.  It runs no program: the inputs are drawn on the
device from each seed as a run draws them.

    python3 -m zkbench.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line: each seed's numbers beside their limits."""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import registry


def readings(workload: str, seed: int, device, root: str = registry.ROOT):
    spec = registry.bench(root)
    cell = registry.cell(spec, workload)
    traffic = registry.traffic(cell["traffic"], root)
    entry = registry.entry(traffic["entry"]).Entry(
        registry.config(spec, cell["config"], root), traffic, seed, device)
    entry.make_inputs()
    return entry.check(entry.control())


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = {}
    for seed in args.seeds:
        t = time.perf_counter()
        out[seed] = readings(args.workload, seed, dev)
        print(f"seed {seed}: {out[seed]} in {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "device": dev.type,
                      "control": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
