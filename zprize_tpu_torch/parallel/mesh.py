"""The ranks of a sharded run and the collectives between them.

The reference shards its arrays over a device mesh and moves data with
SPMD collectives (psum, all_gather, all_to_all, ppermute).  Here a sharded
run is a world of ranks, one process each, joined by `torch.distributed`:
every rank holds its block of rows of each sharded array on its own device,
runs the same program, and meets the others only in the helpers below.
Nothing else in the port calls `torch.distributed` directly.

A row-sharded array of n rows in a world of D ranks: rank r holds the
global rows [r n/D, (r+1) n/D).

`spawn_world` starts the ranks:

* on the CPU, gloo ranks (the tests);
* on the card, rank r on `cuda:{r % device_count}`; NCCL when the ranks
  are no more than the cards.  More ranks than cards (several ranks
  sharing one card) need `backend="gloo"`, asked for explicitly: NCCL
  refuses two ranks on one device.  Gloo's collectives run on host
  memory here: with gloo, a rank's tensors on the card go to the host for
  each collective and come back (`World.staged`); the compute stays on
  the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device

TIMEOUT_S = 300.0        # a collective's limit, and the whole run's default


@dataclasses.dataclass(frozen=True)
class World:
    """One rank's view of its group: its index and the group's size (of
    the group, not of the whole job), its device (the card unless the
    caller asks for the CPU), the backend and the process group (None for
    the default group)."""
    rank: int
    size: int
    device: torch.device | None = None
    backend: str = "gloo"
    group: object = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def staged(self) -> bool:
        """True where collectives go through host memory (gloo ranks on
        the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def subgroup(self, ranks) -> World | None:
        """The world of `ranks` (ranks of this world), or None on a rank
        outside it.  Every rank of this world must call it, in the same
        order as every other `subgroup` call."""
        ranks = sorted(ranks)
        glob = [r if self.group is None
                else dist.get_global_rank(self.group, r) for r in ranks]
        group = dist.new_group(ranks=glob, backend=self.backend)
        if self.rank not in ranks:
            return None
        return World(ranks.index(self.rank), len(ranks), self.device,
                     self.backend, group)


def shard_rows(x: torch.Tensor, world: World) -> torch.Tensor:
    """This rank's block of the leading axis of x (the counterpart of the
    reference's `shard_batch`)."""
    n = x.shape[0]
    if n % world.size:
        raise ValueError(f"{n} rows do not split over {world.size} ranks")
    m = n // world.size
    return x[world.rank * m:(world.rank + 1) * m]


def _out(x: torch.Tensor, world: World) -> torch.Tensor:
    return x.cpu() if world.staged else x


def _back(x: torch.Tensor, world: World) -> torch.Tensor:
    return x.to(world.device) if world.staged else x


def all_gather_rows(x: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's x (one shape on all ranks) concatenated along axis 0 in
    rank order, on every rank."""
    src = _out(x.contiguous(), world)
    parts = [torch.empty_like(src) for _ in range(world.size)]
    dist.all_gather(parts, src, group=world.group)
    return _back(torch.cat(parts), world)


def _exchange(send: torch.Tensor, out_rows: int, in_splits, out_splits,
              world: World) -> torch.Tensor:
    """all_to_all_single along axis 0: send[in_splits[s] rows] to rank s;
    the rows from rank q (out_splits[q] of them) land in rank order."""
    src = _out(send.contiguous(), world)
    dst = torch.empty((out_rows, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_to_all_single(dst, src, output_split_sizes=list(out_splits),
                           input_split_sizes=list(in_splits),
                           group=world.group)
    return _back(dst, world)


def all_to_all_tiled(x: torch.Tensor, split_axis: int, concat_axis: int,
                     world: World) -> torch.Tensor:
    """The reference's tiled all_to_all (`lax.all_to_all(..., tiled=True)`):
    chunk i of `split_axis` (of size x.shape[split_axis] / D) goes to rank
    i, and the chunks received are concatenated along `concat_axis` in
    rank order.  The split axis moves to the front for the exchange,
    which splits axis 0 only."""
    d = world.size
    s = x.shape[split_axis]
    if s % d:
        raise ValueError(f"axis {split_axis} of {s} does not split over "
                         f"{d} ranks")
    front = torch.movedim(x, split_axis, 0)
    got = _exchange(front, s, [s // d] * d, [s // d] * d, world)
    chunks = [torch.movedim(c, 0, split_axis)
              for c in got.reshape(d, s // d, *front.shape[1:])]
    return torch.cat(chunks, dim=concat_axis)


def shift_rows(x: torch.Tensor, shift: int, world: World) -> torch.Tensor:
    """This rank's block of `torch.roll(G, shift, 0)`, G the row-sharded
    array whose block x is (|shift| at most the block's rows): the rows
    that cross a rank boundary come from an all-gather of every rank's
    boundary rows (the reference's ppermute and `jnp.roll`)."""
    k, m, d = abs(shift), x.shape[0], world.size
    if k > m:
        raise ValueError(f"shift {shift} exceeds the block of {m} rows")
    if k == 0:
        return x
    if shift < 0:          # row i takes global row i + k
        heads = all_gather_rows(x[:k], world)
        nxt = (world.rank + 1) % d
        return torch.cat([x[k:], heads[nxt * k:(nxt + 1) * k]])
    tails = all_gather_rows(x[m - k:], world)
    prv = (world.rank - 1) % d
    return torch.cat([tails[prv * k:(prv + 1) * k], x[:m - k]])


def take_rows(x: torch.Tensor, start: int, stop: int, n_out: int,
              world: World) -> torch.Tensor:
    """Rows [start, stop) of the row-sharded array whose block x is,
    zero-padded (or cut) to n_out rows, row-sharded: this rank's block of
    n_out / D rows.  Each row moves once, from the rank that holds it to
    the rank that needs it (an all_to_all with uneven splits)."""
    d, r = world.size, world.rank
    b_in = x.shape[0]
    if n_out % d:
        raise ValueError(f"{n_out} rows do not split over {d} ranks")
    b_out = n_out // d
    stop = min(stop, start + n_out, b_in * d)

    def span(lo, hi, blo, bhi):
        """Source rows of [lo, hi) that land in target rows [blo, bhi)."""
        return max(lo, start + blo), min(hi, start + bhi)

    in_splits, out_splits = [], []
    for s in range(d):       # my rows -> target block of rank s
        lo, hi = span(max(r * b_in, start), min((r + 1) * b_in, stop),
                      s * b_out, (s + 1) * b_out)
        in_splits.append(max(0, hi - lo))
    for q in range(d):       # rank q's rows -> my target block
        lo, hi = span(max(q * b_in, start), min((q + 1) * b_in, stop),
                      r * b_out, (r + 1) * b_out)
        out_splits.append(max(0, hi - lo))
    first = max(r * b_in, start) - r * b_in
    send = x[first:first + sum(in_splits)] if sum(in_splits) else x[:0]
    got = _exchange(send, sum(out_splits), in_splits, out_splits, world)
    pad = b_out - got.shape[0]        # rows past `stop`: zero
    if pad:
        got = torch.cat([got, got.new_zeros((pad, *x.shape[1:]))])
    return got


def choose_backend(world_size: int, device: torch.device,
                   backend: str | None) -> str:
    """gloo on the CPU; on the card NCCL, or gloo where the caller asks
    for it.  More ranks than cards without `backend="gloo"` raise."""
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo")
        return "gloo"
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    cards = torch.cuda.device_count()
    if backend is None:
        if world_size > cards:
            raise ValueError(
                f"{world_size} ranks on {cards} card(s): NCCL takes one rank "
                "a card; pass backend='gloo' to share the cards")
        return "nccl"
    if backend == "nccl" and world_size > cards:
        raise ValueError(f"NCCL with {world_size} ranks on {cards} card(s)")
    return backend


def _rank_main(fn, rank, size, device_type, backend, init_file, timeout_s,
               args, results):
    try:
        # a fair share of the host's cores: ranks that each took all of
        # them would spin against one another in every small op
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        if device_type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(World(rank, size, dev, backend), *args)
        if device_type == "cuda":
            torch.cuda.synchronize(dev)
        results.put((rank, True, out))
    except BaseException:        # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, world_size: int, device=None, backend: str | None = None,
                args: tuple = (), timeout_s: float = TIMEOUT_S) -> list:
    """Run fn(world, *args) on `world_size` new ranks (processes started
    by spawn, not fork) on `device` (the card unless the caller asks for
    the CPU) and return their results in rank order.  `fn` must be a
    module-level function of a module the ranks can import; its results
    and `args` travel by pickle.  The ranks meet through a fresh file
    (`file://` rendezvous), so concurrent worlds never share a port.  A
    rank that raises, dies or outlasts `timeout_s` ends the others and
    makes the call raise."""
    dev = resolve_device(device)
    backend = choose_backend(world_size, dev, backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="zprize_world_")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, dev.type, backend,
                               init_file, timeout_s, args, results),
                         daemon=True)
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        out: dict = {}
        exited: dict = {}        # rank -> when it was first seen exited
        deadline = time.monotonic() + timeout_s
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode is not None:
                        exited.setdefault(r, now)
                # a result sent just before the exit may still be in the
                # pipe: a rank is dead once it has been gone a while
                dead = [r for r, t in exited.items()
                        if r not in out and now - t > 5.0]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of {world_size} "
                                       "died without a result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                if now > deadline:
                    raise TimeoutError(f"{world_size - len(out)} of "
                                       f"{world_size} ranks gave no result "
                                       f"in {timeout_s:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
