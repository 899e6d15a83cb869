"""The calls a window drives, one module an entry, named by the traffic
file's "entry".  Each module defines `Entry(config, traffic, seed,
device)` with:

  unit             what one unit of work is, in the metrics' names
  make_inputs()    the benchmark's inputs, drawn from the seed
  init()           the program's untimed init; returns its seconds
  call()           one timed call; returns the units it completed and
                   keeps its outputs for the check
  release()        drops the program's state
  check(outputs)   {name: (number, limit)} of the comparison with the
                   plain reference; outputs default to the calls' own
  control()        the control's outputs, in the calls' place
  plan()           what the run reports of the program's plan (a dict)
  kernel_work(k)   (rows, lanes) that kernel k walks in one call, or None
"""

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
