"""Pippenger bucket-method MSM over BLS12-377 G1 in twisted-Edwards form.

Two routes, chosen by the plan (c, g, m) of `plan_collapse` (the
reference package's choice: m > 1 below 2^23 points, m = 1 from 2^24), or
m = 1 when the caller asks for no collapse.

The collapsed route (m > 1):

1. init: the window-collapse table of m multiples 2^(c*g*j)·P
   (`te_path.prepare_points_collapsed`, kernel `te_dbl_chain`);
2. MSB-negated signed c-bit digits, folded from m*g windows onto g bucket
   sets (`signed_digits`);
3. per bucket set, the table rows sorted by |digit| (`torch.sort`, bucket
   runs by `torch.searchsorted`) and summed per bucket (kernel
   `te_bucket_accumulate`).

The m = 1 route (`window_sums_m1`):

1. init: one operand per point (`te_path.prepare_points`, in blocks);
2. windows in chunks, as many in flight as the memory plan allows
   (`windows_in_flight`): signed digits of the chunk with the carry
   riding between chunks (`signed_digits_range`), a sort of each window
   by |digit| (`sort_windows`), and the bucket sums read through the sort
   permutation straight from the table (kernel `te_gather_accumulate`).

Both then take sum_b b*B_b per window (triangle merge, or bit-decomposed
below 1024 buckets; kernels `te_full_add` and `te_combine`), the window
combine (kernel `te_combine`) and the exact TE->SW conversion of the
single result on the host.

Routes not in this port yet raise NotImplementedError naming their queue
in ROADMAP.md: the short-Weierstrass route (BLS12-381 G1) and the
jittable batch forms.
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
from .accum_kernel import te_bucket_accumulate, te_gather_accumulate

_SW_ROUTE = ("the short-Weierstrass MSM route is not ported yet: "
             "ROADMAP.md Queue 1, item 11")


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
    """Init-stage preprocessing: `table` (m*n, 3, nw) holds the
    precomputed operands of the m blocks 2^(c*g*j)·P, row j*n + i."""
    table: torch.Tensor
    c: int
    g: int                 # bucket sets after collapse
    m: int                 # stored multiples per point
    n: int                 # original point count


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
    c_max = 32 - BASE_BITS + 1          # 18 at BASE_BITS=15
    c_range = [c] if c else range(8, c_max + 1)
    if not all(8 <= cc <= c_max for cc in c_range):
        raise ValueError(f"window bits must lie in [8, {c_max}], got {c}")
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


def require_te(curve: CurveSpec) -> None:
    """Raise NotImplementedError for a curve with no twisted-Edwards form."""
    try:
        te.te_params(curve)
    except ValueError as exc:
        raise NotImplementedError(f"{curve.name}: {_SW_ROUTE}") from exc


def prepare_points(curve: CurveSpec, points: sw.Affine, c: int | None = None,
                   budget_bytes: int | None = None,
                   collapse: bool = True) -> PreparedTe:
    """Preprocess a fixed point set for repeated MSMs (the untimed init):
    TE conversion and the point table.  With `collapse` the plan of
    `plan_collapse` decides; without, c = `c` or `default_window_bits(n)`
    and m = 1 (the reference's ZPRIZE_PRECOMPUTE=0)."""
    require_te(curve)
    n = points.x.shape[0]
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
        c: int | None = None, prepared: PreparedTe | None = None,
        window_budget: int | None = None) -> sw.Point:
    """sum_i scalars[i] * points[i] for canonical scalar limb planes
    (n, L) (base 2^15, limbs < 2^15: the benchmark's compact form, also
    as its int16 view).  Only points.inf is read when `prepared` is given.
    `window_budget` bounds the bytes the m = 1 route's windows in flight
    may hold (default: from the card's free memory; no bound on the CPU);
    the result does not depend on it."""
    require_te(curve)
    if prepared is None:
        prepared = prepare_points(curve, points, c)
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


def msm_jit_static(*args, **kwargs):
    raise NotImplementedError("msm_jit_static (the fixed-shape SW MSM) is "
                              "not ported yet: ROADMAP.md Queue 1, item 11")


def msm_jit_batch(*args, **kwargs):
    raise NotImplementedError("msm_jit_batch (batched commits) is not "
                              "ported yet: ROADMAP.md Queue 1, item 11")
