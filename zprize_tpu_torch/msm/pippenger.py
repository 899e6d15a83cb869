"""Pippenger bucket-method MSM: the twisted-Edwards routes (BLS12-377 G1)
and the short-Weierstrass route (any a = 0 curve; BLS12-381 G1).

`prepare_points` picks the route: TE wherever the curve has a TE form,
unless the caller passes te=False (the reference package's ZPRIZE_TE=0);
SW otherwise.  The TE routes are chosen by the plan (c, g, m) of
`plan_collapse` (the reference package's choice: m > 1 below 2^23
points, m = 1 from 2^24), or m = 1 when the caller asks for no collapse.

The collapsed TE route (m > 1):

1. init: the window-collapse table of m multiples 2^(c*g*j)·P
   (`te_path.prepare_points_collapsed`, kernel `te_dbl_chain`);
2. MSB-negated signed c-bit digits, folded from m*g windows onto g bucket
   sets (`signed_digits`);
3. per bucket set, the table rows sorted by |digit| (`torch.sort`, bucket
   runs by `torch.searchsorted`) and summed per bucket (kernel
   `te_bucket_accumulate`).

The m = 1 TE route (`window_sums_m1`):

1. init: one operand per point (`te_path.prepare_points`, in blocks);
2. windows in chunks, as many in flight as the memory plan allows
   (`windows_in_flight`): signed digits of the chunk with the carry
   riding between chunks (`signed_digits_range`), a sort of each window
   by |digit| (`sort_windows`), and the bucket sums read through the sort
   permutation straight from the table (kernel `te_gather_accumulate`).

Both then take sum_b b*B_b per window (triangle merge, or bit-decomposed
below 1024 buckets; kernels `te_running_sum`, `te_tree_sum` and
`te_combine`), the window
combine (kernel `te_combine`) and the exact TE->SW conversion of the
single result on the host.

The SW route (`msm_sw`; c = `default_window_bits(n)`, no table: init
keeps the affine planes):

1. signed digits of every window, zero for points at infinity;
2. windows grouped by the bucket count their digits need
   (`window_groups`); per group, one sort of each window by |digit|
   (`sort_windows`) and the bucket sums of all its windows in one launch
   of `sw_gather_accumulate`, reading the points through the permutation
   (a group with runs far above a full window's mean, such as the narrow
   top windows, is cut into slices of the points first: `window_sums_sw`);
3. the bucket merge (`merge_buckets_all`): from 1024 buckets on, a chunked
   running sum (kernel `sw_running_sum`, one launch for the whole group)
   and a few `sw_full_add` tree launches; below, the bit-decomposed scan
   on `sw_full_add`; either way its last fold in one `sw_combine` launch;
4. the window combine (`combine_windows`): one `sw_combine` launch, one
   thread a lane folding MSB-first with the dedicated a = 0 doubling.

Steps 3 and 4 are bound by 32-bit integer multiplies.  Measured on an
H100 for a 2^18 BLS12-381 MSM (PERF.md): the full group's merge 1.0-1.4
ms, of it the running sum 0.26 ms against a 0.057 ms bound; the final
combine 2.37 ms, one thread's chain of 2,320 dependent field multiplies.

`msm_jit_static` and `msm_jit_batch` are the reference's fixed-shape SW
forms (two window groups, an occupancy cap that raises when exceeded);
`msm_jit_batch` puts all B x n_win full-width windows of a batch in one
`sw_gather_accumulate` launch.
"""

from __future__ import annotations

import math
import typing

import torch

from ..curve import sw, te
from ..curve.spec import CurveSpec
from ..field import fp
from ..field.spec import BASE_BITS
from . import te_path
from .accum_kernel import (sw_accumulate_ranks, sw_combine, sw_full_add,
                           sw_gather_accumulate, sw_running_sum,
                           te_bucket_accumulate, te_gather_accumulate)

# the largest window the digit extraction takes: a window spans at most
# three base-2^15 limbs (18 at BASE_BITS = 15)
C_MAX = 32 - BASE_BITS + 1


def default_window_bits(n: int) -> int:
    """Heuristic window size balancing accumulation (n*w adds) against the
    per-window merge ((c-1) * 2^(c-1) adds)."""
    if n <= 0:
        return 4
    return int(min(13, max(4, math.log2(max(n, 16)) - 3)))


def num_windows(curve: CurveSpec, c: int) -> int:
    # +1 window absorbs the final signed-digit carry.
    return (curve.scalar.p.bit_length() + c - 1) // c + 1


def signed_digits(curve: CurveSpec, c: int, n_win: int,
                  scalars: torch.Tensor) -> torch.Tensor:
    """Canonical scalar limb planes (n, L), base 2^15, any integer dtype ->
    (n_win, n) int64 signed digits in [-2^(c-1), 2^(c-1)).  A window whose
    value reaches 2^(c-1) is negated and carries one into the next; the top
    window absorbs the last carry."""
    carry = torch.zeros(scalars.shape[0], dtype=torch.int32,
                        device=scalars.device)
    digits, _ = signed_digits_range(curve, c, 0, n_win, scalars.t(), carry)
    return digits.to(torch.int64)


def signed_digits_range(curve: CurveSpec, c: int, w0: int, w1: int,
                        limbs: torch.Tensor, carry: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows w0..w1-1 of the signed digits of limb-major scalars
    (L, n) (base 2^15, limbs < 2^15, any integer dtype, e.g. the int16
    view of the compact form), resuming from `carry` (n,) int32, the carry
    out of window w0 - 1 (zeros for w0 = 0).  Returns the (w1 - w0, n)
    int32 digits and the carry out of window w1 - 1: the carry chain is
    sequential in the window, so a chunk of windows needs only that one
    vector from the chunks before it."""
    n_limbs, n = limbs.shape
    half = 1 << (c - 1)
    zero = torch.zeros(n, dtype=torch.int64, device=limbs.device)

    def limb(i):
        return limbs[i].to(torch.int64) if i < n_limbs else zero

    digits = torch.empty((w1 - w0, n), dtype=torch.int32, device=limbs.device)
    for k, w in enumerate(range(w0, w1)):
        i0, sh = divmod(w * c, BASE_BITS)
        word = (limb(i0) | (limb(i0 + 1) << BASE_BITS)
                | (limb(i0 + 2) << 2 * BASE_BITS))
        raw = ((word >> sh) & ((1 << c) - 1)).to(torch.int32) + carry
        over = raw >= half
        digits[k] = torch.where(over, raw - (1 << c), raw)
        carry = over.to(torch.int32)
    return digits, carry


def scalar_limbs(curve: CurveSpec, words: torch.Tensor) -> torch.Tensor:
    """Montgomery scalar-field words (n, nw) -> the canonical base-2^15
    limb planes (n, L) int32 that `msm` reads, on their device: leave
    Montgomery form, then cut the 32-bit words into 15-bit limbs."""
    fr = curve.scalar
    w = fp.from_mont(fr, words).to(torch.int64) & 0xFFFFFFFF
    w = torch.nn.functional.pad(w, (0, 1))
    bit = torch.arange(fr.n_limbs, device=w.device) * BASE_BITS
    i, sh = bit // 32, bit % 32
    limbs = (w[:, i] >> sh) | (w[:, i + 1] << (32 - sh))
    return (limbs & ((1 << BASE_BITS) - 1)).to(torch.int32)


class PreparedTe(typing.NamedTuple):
    """Init-stage preprocessing of the TE routes: `table` (m*n, 3, nw)
    holds the precomputed operands of the m blocks 2^(c*g*j)·P, row
    j*n + i."""
    table: torch.Tensor
    c: int
    g: int                 # bucket sets after collapse
    m: int                 # stored multiples per point
    n: int                 # original point count

    @property
    def device(self) -> torch.device:
        return self.table.device


class PreparedSw(typing.NamedTuple):
    """The SW route's init: the affine coordinate planes (n, nw) that the
    accumulate reads through the sort permutation, and the window width.
    No table is built (the reference returns no handle here)."""
    x: torch.Tensor
    y: torch.Tensor
    c: int
    n: int

    @property
    def device(self) -> torch.device:
        return self.x.device


def plan_collapse(curve: CurveSpec, n: int, c: int | None = None,
                  budget_bytes: int | None = None) -> tuple[int, int, int]:
    """Choose (c, g, m) for the window-precompute collapse: minimise
    accumulate adds (W*n mixed) + merge adds subject to the table budget.

    The cost model, the 4 GiB default budget (sized by the reference
    package for its device), its table row size (3 planes of 13 packed
    words) and the bound c <= 18 are the reference package's, so that both
    choose the same plan for the same input."""
    if budget_bytes is None:
        budget_bytes = 4 << 30
    h = (curve.field.n_limbs + 1) // 2
    row_bytes = 3 * h * 4
    m_cap = max(1, budget_bytes // max(1, n * row_bytes))
    best = None
    c_range = [c] if c else range(8, C_MAX + 1)
    if not all(8 <= cc <= C_MAX for cc in c_range):
        raise ValueError(f"window bits must lie in [8, {C_MAX}], got {c}")
    for cc in c_range:
        w = num_windows(curve, cc)
        m = min(m_cap, w)
        g = -(-w // m)
        m = -(-w // g)  # shrink m back to what g actually needs
        nbe = 1 << (cc - 1)
        if te_path.triangle_split(g, nbe) is not None:
            # triangle merge: 2 full adds per bucket (9M vs the mixed 7M)
            merge = g * 2.6 * nbe
        else:
            bits = max(1, nbe.bit_length())
            merge = g * bits * nbe * 8 / 7.0
        cost = w * n + merge
        if best is None or cost < best[0]:
            best = (cost, cc, g, m)
    return best[1], best[2], best[3]


def has_te_form(curve: CurveSpec) -> bool:
    try:
        te.te_params(curve)
    except ValueError:
        return False
    return True


def use_te(curve: CurveSpec, te_route: bool | None) -> bool:
    """Whether the MSM takes a TE route: `te_route`, or by default
    whenever the curve has a TE form; te_route=True on a curve with none
    raises ValueError."""
    has = has_te_form(curve)
    if te_route and not has:
        raise ValueError(f"{curve.name} has no twisted-Edwards form: use "
                         "the short-Weierstrass route (te=False)")
    return has if te_route is None else te_route


def prepare_points(curve: CurveSpec, points: sw.Affine, c: int | None = None,
                   budget_bytes: int | None = None, collapse: bool = True,
                   te: bool | None = None) -> PreparedTe | PreparedSw:
    """Preprocess a fixed point set for repeated MSMs (the untimed init).

    On a TE route (`use_te`): TE conversion and the point table; with
    `collapse` the plan of `plan_collapse` decides, without, c = `c` or
    `default_window_bits(n)` and m = 1 (the reference's
    ZPRIZE_PRECOMPUTE=0).  On the SW route: the affine planes and c = `c`
    or `default_window_bits(n)`; `budget_bytes` and `collapse` do not
    apply."""
    n = points.x.shape[0]
    if not use_te(curve, te):
        c = c or default_window_bits(n)
        if not 2 <= c <= C_MAX:
            raise ValueError(f"window bits must lie in [2, {C_MAX}], got {c}")
        return PreparedSw(points.x.contiguous(), points.y.contiguous(), c, n)
    if collapse:
        c, g, m = plan_collapse(curve, n, c, budget_bytes)
    else:
        c = c or default_window_bits(n)
        g, m = num_windows(curve, c), 1
    if m == 1:
        table = te_path.prepare_points(curve, points.x, points.y, points.inf)
    else:
        table = te_path.prepare_points_collapsed(
            curve, points.x, points.y, points.inf, c * g, m)
    return PreparedTe(table, c, g, m, n)


def msm(curve: CurveSpec, points: sw.Affine, scalars: torch.Tensor,
        c: int | None = None, prepared: PreparedTe | PreparedSw | None = None,
        window_budget: int | None = None, cap: int | None = None,
        te: bool | None = None) -> sw.Point:
    """sum_i scalars[i] * points[i] for canonical scalar limb planes
    (n, L) (base 2^15, limbs < 2^15: the benchmark's compact form, also
    as its int16 view), as a projective point of host words.  Only
    points.inf is read when `prepared` is given; without it `c` and `te`
    go to `prepare_points`.  `window_budget` bounds the bytes the m = 1
    TE route's windows in flight may hold (default: from the card's free
    memory; no bound on the CPU).  `cap` is the reference's per-pass
    occupancy cap, kept for API parity: every bucket run is walked whole.
    The result depends on neither."""
    if prepared is None:
        prepared = prepare_points(curve, points, c, te=te)
    if isinstance(prepared, PreparedSw):
        return sw.Point(*msm_sw(curve, prepared, points.inf,
                                scalars).cpu().unbind(-2))
    if prepared.m == 1:
        sums = window_sums_m1(curve, prepared, points.inf, scalars,
                              window_budget)
        combined = te_path.combine_windows_te(curve, prepared.c, sums)
    else:
        combined = _msm_te_sorted(curve, prepared, points.inf, scalars)
    return _te_result_host(curve, combined)


def bucket_runs(curve: CurveSpec, prep: PreparedTe, inf: torch.Tensor,
                scalars: torch.Tensor):
    """Yield, per bucket set, the inputs of `te_bucket_accumulate`: the
    table rows sorted by |digit| (rows, sign) and each bucket's run
    (starts, counts) for buckets 1..2^(c-1)."""
    c, g, m, n = prep.c, prep.g, prep.m, prep.n
    dev = prep.table.device
    if tuple(scalars.shape[:1]) != (n,) or tuple(inf.shape) != (n,):
        raise ValueError(f"expected {n} scalars and infinity flags, got "
                         f"{tuple(scalars.shape)} and {tuple(inf.shape)}")
    n_win = num_windows(curve, c)
    digits = signed_digits(curve, c, n_win, scalars.to(dev))
    # window j*g + gi of point i -> bucket set gi, table row j*n + i
    digits = torch.nn.functional.pad(digits, (0, 0, 0, m * g - n_win))
    digits = digits.reshape(m, g, n).transpose(0, 1).reshape(g, m * n)
    digits = torch.where(inf.to(dev).repeat(m)[None, :], 0, digits)
    buckets = torch.arange(1, (1 << (c - 1)) + 1, device=dev)
    for d in digits:
        key, perm = torch.sort(d.abs())
        starts = torch.searchsorted(key, buckets)
        counts = torch.searchsorted(key, buckets, right=True) - starts
        yield (prep.table[perm], (d[perm] < 0).to(torch.int32), starts,
               counts)


def _msm_te_sorted(curve: CurveSpec, prep: PreparedTe, inf: torch.Tensor,
                   scalars: torch.Tensor) -> torch.Tensor:
    """Bucket sort -> accumulate -> merge -> combine; returns the combined
    extended TE point (4, nw) on the device."""
    c, g = prep.c, prep.g
    sums = torch.stack([te_bucket_accumulate(curve, *run)
                        for run in bucket_runs(curve, prep, inf, scalars)])
    if te_path.triangle_split(g, sums.shape[1]) is not None:
        merged = te_path.merge_buckets_te_triangle(curve, c, sums)
    else:
        merged = te_path.merge_buckets_te(curve, c, sums)
    return te_path.combine_windows_te(curve, c, merged)


def window_groups(curve: CurveSpec, c: int, n_win: int, full_nbe: int
                  ) -> dict[int, list[int]]:
    """Windows grouped by the bucket count their digits need: a window
    with fewer raw bits (the top carry window) gets a narrower bucket
    range.  Same grouping as the reference package."""
    scalar_bits = curve.scalar.p.bit_length()
    groups: dict[int, list[int]] = {}
    for w in range(n_win):
        raw_bits = min(c, max(0, scalar_bits - w * c))
        dmax = min(full_nbe, (1 << raw_bits) + 1)  # |digit| bound
        nbe = min(full_nbe, max(4, 1 << (dmax - 1).bit_length()))
        groups.setdefault(nbe, []).append(w)
    return groups


def sort_windows(digits: torch.Tensor, nbe: int):
    """The bucket sort of W windows of signed digits (W, n) int32 over
    buckets 1..nbe: (perm (W, n) int64, the indices sorted by |digit|;
    sign (W, n) int32, 1 where the sorted digit is negative; starts and
    counts (W, nbe) int64, bucket b's run).  One sort per window, of the
    int32 key 2|d| + (d < 0): its sorted keys carry the sign, and bucket
    b's run lies between the keys 2b and 2b + 2."""
    n_win, n = digits.shape
    dev = digits.device
    perm = torch.empty((n_win, n), dtype=torch.int64, device=dev)
    sign = torch.empty((n_win, n), dtype=torch.int32, device=dev)
    edges = 2 * torch.arange(1, nbe + 2, dtype=torch.int32, device=dev)
    bounds = []
    for w in range(n_win):
        d = digits[w]
        key, perm[w] = torch.sort((d.abs() << 1) | (d < 0).to(torch.int32))
        sign[w] = key & 1
        bounds.append(torch.searchsorted(key, edges))
        del key
    bounds = torch.stack(bounds)
    starts = bounds[:, :-1].contiguous()
    return perm, sign, starts, (bounds[:, 1:] - starts).contiguous()


def window_bytes(n: int, nbe: int) -> int:
    """Device bytes one window in flight holds in `window_sums_m1`: its
    digits, sort permutation and signs (16 bytes a point) and its bucket
    sums."""
    return 16 * n + 192 * nbe


def windows_in_flight(n: int, nbe: int, n_windows: int, device: torch.device,
                      budget: int | None = None) -> int:
    """How many windows of n points `window_sums_m1` handles at once: all
    of them if the budget allows, at least one.  The budget is `budget`
    bytes, or on the card nine tenths of what is free (`mem_get_info`,
    plus what PyTorch's allocator holds unused) less the transient of one
    window's sort (40 bytes a point: key, sorted key, permutation and the
    sort's buffers); on the CPU with no budget, all windows."""
    if budget is None:
        if device.type != "cuda":
            return n_windows
        free, _ = torch.cuda.mem_get_info(device)
        free += (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
        budget = int(0.9 * free) - 40 * n
    return max(1, min(n_windows, budget // window_bytes(n, nbe)))


def window_sums_m1(curve: CurveSpec, prep: PreparedTe, inf: torch.Tensor,
                   scalars: torch.Tensor, budget: int | None = None
                   ) -> torch.Tensor:
    """The m = 1 route up to the window combine: per window group, per
    chunk of windows in flight (`windows_in_flight` under `budget`),
    digits -> bucket sort -> te_gather_accumulate -> merge.  Returns the
    (n_win, 4, nw) window sums sum_b b*B_b on the device."""
    c, n = prep.c, prep.n
    dev = prep.table.device
    if tuple(scalars.shape[:1]) != (n,) or tuple(inf.shape) != (n,):
        raise ValueError(f"expected {n} scalars and infinity flags, got "
                         f"{tuple(scalars.shape)} and {tuple(inf.shape)}")
    n_win = num_windows(curve, c)
    limbs = scalars.to(dev).t().contiguous()                    # (L, n)
    inf = inf.to(dev)
    carry = torch.zeros(n, dtype=torch.int32, device=dev)
    window_sums = [None] * n_win
    # groups in ascending window order: the carry chain crosses them
    for nbe, ws in sorted(window_groups(curve, c, n_win, 1 << (c - 1)
                                        ).items(), key=lambda kv: kv[1][0]):
        chunk = windows_in_flight(n, nbe, len(ws), dev, budget)
        for lo in range(ws[0], ws[-1] + 1, chunk):
            hi = min(ws[-1] + 1, lo + chunk)
            digits, carry = signed_digits_range(curve, c, lo, hi, limbs,
                                                carry)
            digits.masked_fill_(inf, 0)
            runs = sort_windows(digits, nbe)
            del digits
            sums = te_gather_accumulate(curve, prep.table, *runs)
            del runs
            if te_path.triangle_split(hi - lo, nbe) is not None:
                merged = te_path.merge_buckets_te_triangle(curve, c, sums)
            else:
                merged = te_path.merge_buckets_te(curve, c, sums)
            del sums
            window_sums[lo:hi] = merged
    return torch.stack(window_sums)


def _te_result_host(curve: CurveSpec, combined: torch.Tensor) -> sw.Point:
    """Extended TE point (4, nw) -> SW projective point (host words, CPU)
    through the exact python-int conversion `te.te_to_sw_host`."""
    f = curve.field
    x, y, z, _ = (int(v) for v in fp.to_ints(f, combined))
    sx, sy, sz = te.te_to_sw_host(curve, x, y, z)
    return sw.Point(*(fp.from_ints(f, [v])[0] for v in (sx, sy, sz)))


# ---------------------------------------------------------------------------
# the short-Weierstrass route
# ---------------------------------------------------------------------------


def _check_inputs(n: int, scalars: torch.Tensor, inf: torch.Tensor) -> None:
    if tuple(scalars.shape[-2:-1]) != (n,) or tuple(inf.shape) != (n,):
        raise ValueError(f"expected {n} scalars and infinity flags, got "
                         f"{tuple(scalars.shape)} and {tuple(inf.shape)}")


def sw_digits(curve: CurveSpec, c: int, scalars: torch.Tensor,
              inf: torch.Tensor) -> torch.Tensor:
    """Signed digits of every window of every batch: scalars (..., n, L)
    limb planes -> (batch * n_win, n) int32, row b * n_win + w, zero for
    points at infinity."""
    n_win = num_windows(curve, c)
    n = scalars.shape[-2]
    rows = []
    for s in scalars.reshape(-1, *scalars.shape[-2:]):
        carry = torch.zeros(n, dtype=torch.int32, device=s.device)
        digits, _ = signed_digits_range(curve, c, 0, n_win,
                                        s.t().contiguous(), carry)
        rows.append(digits.masked_fill_(inf, 0))
    return torch.cat(rows)


def bucket_counts_all(c: int, digits: torch.Tensor):
    """The reference's bucket grouping of every window at once: digits
    (W, n) -> (perm (W, n), the indices stably sorted by |digit|; starts
    and counts (W, 2^(c-1) + 1), the run of each bucket 0..2^(c-1); the
    largest count of buckets 1.. per window (W,))."""
    key, perm = torch.sort(digits.abs(), dim=1, stable=True)
    ids = torch.arange((1 << (c - 1)) + 1, dtype=key.dtype,
                       device=key.device).expand(key.shape[0], -1)
    starts = torch.searchsorted(key, ids.contiguous())
    counts = torch.searchsorted(key, ids.contiguous(), right=True) - starts
    return perm, starts, counts, counts[:, 1:].amax(dim=1)


def accumulate_pass_all(curve: CurveSpec, c: int, cap: int, px, py,
                        digits: torch.Tensor, perm: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        n_buckets_eff: int | None = None,
                        rank0: int = 0) -> sw.Point:
    """The reference's plain accumulate (its jittable path) on the plain
    engine: bucket sums over ranks rank0 .. rank0 + cap - 1 of every run
    of buckets 1..n_buckets_eff, in the grouping of `bucket_counts_all`,
    as a (W, n_buckets_eff) projective point.  The route itself runs
    `sw_gather_accumulate`, which walks every run whole."""
    nbe = n_buckets_eff or 1 << (c - 1)
    sign = (digits.gather(1, perm) < 0).to(torch.int32)
    return sw_accumulate_ranks(curve, px, py, perm, sign,
                               starts[:, 1:nbe + 1], counts[:, 1:nbe + 1],
                               rank0, cap)


def _sum_rows(curve: CurveSpec, pts: torch.Tensor) -> torch.Tensor:
    """Tree-reduce points (m, ..., 3, nw) along axis 0 in place (log-depth
    `sw_full_add` launches: the last half onto the first, the middle row
    of an odd count riding along); returns the sum (..., 3, nw)."""
    m = pts.shape[0]
    skip = torch.zeros(pts[0].shape[:-2].numel(), dtype=torch.int32,
                       device=pts.device)
    flat = pts.reshape(m, -1, *pts.shape[-2:])
    while m > 1:
        half = m // 2
        sw_full_add(curve, flat[:half].reshape(-1, *pts.shape[-2:]),
                    flat[m - half:m].reshape(-1, *pts.shape[-2:]),
                    skip.repeat(half))
        m -= half
    return pts[0]


def merge_buckets_all(curve: CurveSpec, c: int, bucket_sums: torch.Tensor
                      ) -> torch.Tensor:
    """sum_b b*B_b per window (the reference's `merge_buckets_pallas`):
    bucket_sums (W, nbe, 3, nw) -> (W, 3, nw).

    Where `te_path.triangle_split` splits the group (from 1024 buckets
    on; nbe a power of two, as every window group's is), a chunked
    running sum (`_merge_running_sum`).  Otherwise the
    reference's bit decomposition: the per-bit sums S_j = sum of the
    buckets whose id has bit j run as a scan over groups of up to 128
    bucket columns, one `sw_full_add` launch a group over (column, bit,
    window) lanes, a lane skipping the buckets that lack its bit; then a
    tree over the columns, and the fold sum_j 2^j S_j in one `sw_combine`
    launch (c = 1)."""
    n_win, nbe = bucket_sums.shape[:2]
    split = te_path.triangle_split(n_win, nbe)
    if split is not None and nbe & (nbe - 1) == 0:
        return _merge_running_sum(curve, bucket_sums, *split)
    tail = bucket_sums.shape[-2:]
    dev = bucket_sums.device
    n_bits = max(1, nbe.bit_length())
    steps = max(1, nbe // 128)
    cols = nbe // steps
    ids = torch.arange(1, nbe + 1, device=dev).reshape(steps, cols)
    bits = torch.arange(n_bits, device=dev)
    skip = (((ids[:, :, None] >> bits) & 1) == 0).to(torch.int32)
    acc = sw.pack(sw.identity(curve, (cols, n_bits, n_win), dev))
    flat = acc.reshape(-1, *tail)
    for t in range(steps):
        q = bucket_sums[:, t * cols:(t + 1) * cols].transpose(0, 1)
        q = q[:, None].expand(cols, n_bits, n_win, *tail)
        sk = skip[t][:, :, None].expand(cols, n_bits, n_win)
        sw_full_add(curve, flat, q.reshape(-1, *tail).contiguous(),
                    sk.reshape(-1).contiguous())
    return sw_combine(curve, _sum_rows(curve, acc), 1)


def _merge_running_sum(curve: CurveSpec, bucket_sums: torch.Tensor,
                       n_chunks: int, steps: int) -> torch.Tensor:
    """sum_b b*B_b per window by the chunked running sum (as
    `te_path.merge_buckets_te_triangle`): with b = q*S + (j+1),

      sum_b b*B_b = sum_q U_q + S * sum_q q*T_q
      U_q = sum_j (j+1) B_{qS+j+1},  T_q = sum_j B_{qS+j+1}

    both from one `sw_running_sum` launch over all W*C chunk lanes of S
    steps.  One `sw_full_add` tree over the C chunks sums the U_q and the
    per-bit sums S_k = sum of the T_q whose q has bit k, side by side; one
    `sw_combine` launch (c = 1) then folds U + sum_k 2^(log2 S + k) S_k,
    identity steps filling the weights between 2^0 and S.  bucket_sums
    (W, nbe, 3, nw) -> (W, 3, nw)."""
    n_win = bucket_sums.shape[0]
    tail = bucket_sums.shape[-2:]
    dev = bucket_sums.device
    chunks = bucket_sums.reshape(n_win * n_chunks, steps, *tail).contiguous()
    t_q, u_q = sw_running_sum(curve, chunks)
    n_bits = max(1, (n_chunks - 1).bit_length())
    q = torch.arange(n_chunks, device=dev)
    has_bit = ((q >> torch.arange(n_bits, device=dev)[:, None]) & 1).bool()
    ident = sw.pack(sw.identity(curve, (), dev))
    rows = torch.cat([                                # (C, 1 + n_bits, W)
        u_q.reshape(n_win, n_chunks, *tail).transpose(0, 1)[:, None],
        torch.where(has_bit.t()[:, :, None, None, None],
                    t_q.reshape(n_win, n_chunks, *tail)
                    .transpose(0, 1)[:, None], ident)], dim=1)
    sums = _sum_rows(curve, rows.contiguous())        # (1 + n_bits, W)
    log_s = steps.bit_length() - 1
    fold = torch.cat([sums[:1], ident.expand(log_s - 1, n_win, *tail),
                      sums[1:]])
    return sw_combine(curve, fold.contiguous(), 1)


def combine_windows(curve: CurveSpec, c: int, window_sums: torch.Tensor
                    ) -> torch.Tensor:
    """sum_w 2^(c*w) W_w per lane, MSB-first: window_sums (S, L, 3, nw) ->
    (L, 3, nw); c doublings (the complete add of the accumulator to
    itself) and one add per window, all in one `sw_combine` launch."""
    return sw_combine(curve, window_sums.contiguous(), c)


# `window_sums_sw` cuts a crowded window's points into at most this many
# slices, and leaves runs of up to this many points whole (a slice costs
# a sort and a merge of its own)
_MAX_SLICES = 16
_MIN_RUN = 64


def window_sums_sw(curve: CurveSpec, c: int, px: torch.Tensor,
                   py: torch.Tensor, digits: torch.Tensor,
                   groups: dict[int, list[int]], cap: int | None = None,
                   caller: str = "msm") -> torch.Tensor:
    """Window sums sum_b b*B_b of digit rows (R, n): per group {nbe: rows},
    one sort of each row by |digit|, the bucket sums of all the group's
    rows in one `sw_gather_accumulate` launch, and the merge.  With `cap`,
    a full-width bucket (nbe = 2^(c-1)) holding more than `cap` points
    raises (the reference's occupancy contract).  Returns (R, 3, nw).

    One thread walks a bucket's whole run, so a group whose longest run
    is far above a full window's mean (the narrow top windows, whose few
    buckets share all n points; skewed scalars) would leave the launch to
    a few serial threads.  Such a group's points are cut into up to
    `_MAX_SLICES` slices, each a digit row of its own (the digits of the
    other slices zeroed): runs shrink by that factor, and the slices'
    window sums add up to the window's.  A group is cut when its longest
    run exceeds twice a full window's mean run and `_MIN_RUN`."""
    n = digits.shape[1]
    dev = digits.device
    target = max(_MIN_RUN, 2 * (n >> (c - 1)))
    out = [None] * digits.shape[0]
    for nbe, rows in groups.items():
        rows_d = digits[torch.tensor(rows, device=dev)]
        runs = sort_windows(rows_d, nbe)
        longest = int(runs[3].max())
        if cap is not None and nbe == 1 << (c - 1) and longest > cap:
            raise RuntimeError(
                f"{caller}: bucket occupancy {longest} exceeds cap_total "
                f"{cap} (the reference would drop points)")
        slices = max(1, min(_MAX_SLICES, -(-longest // target)))
        if slices > 1:
            owner = torch.arange(n, device=dev) * slices // n
            mine = owner == torch.arange(slices, device=dev)[:, None]
            runs = sort_windows(torch.where(mine, rows_d[:, None], 0)
                                .reshape(-1, n), nbe)
        del rows_d
        merged = merge_buckets_all(
            curve, c, sw_gather_accumulate(curve, px, py, *runs))
        del runs
        if slices > 1:
            merged = _sum_rows(curve, merged.reshape(
                len(rows), slices, *merged.shape[-2:]).transpose(0, 1)
                .contiguous())
        for k, r in enumerate(rows):
            out[r] = merged[k]
    return torch.stack(out)


def msm_sw(curve: CurveSpec, prep: PreparedSw, inf: torch.Tensor,
           scalars: torch.Tensor) -> torch.Tensor:
    """The SW route: digits -> per window group sort, accumulate and
    merge -> combine.  Returns the projective result (3, nw) on the
    device."""
    c, dev = prep.c, prep.device
    _check_inputs(prep.n, scalars, inf)
    n_win = num_windows(curve, c)
    digits = sw_digits(curve, c, scalars.to(dev), inf.to(dev))
    sums = window_sums_sw(curve, c, prep.x, prep.y, digits,
                          window_groups(curve, c, n_win, 1 << (c - 1)))
    return combine_windows(curve, c, sums[:, None])[0]


def _two_groups(curve: CurveSpec, c: int, n_win: int
                ) -> dict[int, list[int]]:
    """The jittable forms' grouping: the full-width windows, and one
    shared group of all narrower windows at the widest narrow width."""
    full = 1 << (c - 1)
    fine = window_groups(curve, c, n_win, full)
    narrow = [(nbe, ws) for nbe, ws in fine.items() if nbe != full]
    groups = {full: fine[full]} if full in fine else {}
    if narrow:
        groups[max(nbe for nbe, _ in narrow)] = sorted(
            w for _, ws in narrow for w in ws)
    return groups


def _msm_fixed(curve: CurveSpec, points: sw.Affine, scalars: torch.Tensor,
               c: int, cap_total: int, check_occupancy: bool,
               caller: str) -> torch.Tensor:
    """The fixed-shape SW MSM of a batch (B, n, L) -> (B, 3, nw) on the
    points' device: the B x n_win windows stacked on one axis, so each of
    the two groups is one accumulate launch and one merge for the whole
    batch."""
    n = points.x.shape[0]
    dev = points.x.device
    _check_inputs(n, scalars, points.inf)
    if not 2 <= c <= C_MAX:
        raise ValueError(f"window bits must lie in [2, {C_MAX}], got {c}")
    bsz, n_win = scalars.shape[0], num_windows(curve, c)
    digits = sw_digits(curve, c, scalars.to(dev), points.inf.to(dev))
    groups = {nbe: [b * n_win + w for b in range(bsz) for w in ws]
              for nbe, ws in _two_groups(curve, c, n_win).items()}
    cap = cap_total if check_occupancy and cap_total < n else None
    sums = window_sums_sw(curve, c, points.x.contiguous(),
                          points.y.contiguous(), digits, groups, cap, caller)
    sums = sums.reshape(bsz, n_win, *sums.shape[-2:]).transpose(0, 1)
    return combine_windows(curve, c, sums)


def msm_jit_static(curve: CurveSpec, points: sw.Affine, scalars: torch.Tensor,
                   c: int, cap_total: int, check_occupancy: bool = True
                   ) -> sw.Point:
    """The reference's fixed-shape MSM: scalars (n, L) limb planes against
    the affine points, on the SW kernels for any curve; a projective point
    on the points' device.  The reference covers `cap_total` ranks per
    bucket and drops the rest; here every run is walked whole, and with
    `check_occupancy` (and cap_total < n) a full-width bucket over
    `cap_total` still raises RuntimeError naming the occupancy, as the
    reference does."""
    return sw.unpack(_msm_fixed(curve, points, scalars[None], c, cap_total,
                                check_occupancy, "msm_jit_static")[0])


def msm_jit_batch(curve: CurveSpec, points: sw.Affine, scalars: torch.Tensor,
                  c: int, cap_total: int, check_occupancy: bool = True
                  ) -> sw.Point:
    """Batched fixed-shape MSM: scalars (B, n, L) against one point set ->
    a (B,)-lane projective point on the points' device.  The batch rides
    the window axis, as in the reference: all B x n_win full-width
    windows take one `sw_gather_accumulate` launch.  Same occupancy
    contract as `msm_jit_static`."""
    return sw.unpack(_msm_fixed(curve, points, scalars, c, cap_total,
                                check_occupancy, "msm_jit_batch"))
