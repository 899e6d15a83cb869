"""Pippenger bucket-method MSM over BLS12-377 G1 in twisted-Edwards form,
on the collapsed, bucket-sorted route.

The route (the reference package's default below 2^23 points):

1. plan (c, g, m) with `plan_collapse`;
2. init: the window-collapse table of m multiples 2^(c*g*j)·P
   (`te_path.prepare_points_collapsed`, kernel `te_dbl_chain`);
3. MSB-negated signed c-bit digits, folded from m*g windows onto g bucket
   sets (`signed_digits`);
4. per bucket set, the table rows sorted by |digit| (`torch.sort`, bucket
   runs by `torch.searchsorted`) and summed per bucket (kernel
   `te_bucket_accumulate`);
5. sum_b b*B_b per set (triangle merge, or bit-decomposed below 1024
   buckets; kernels `te_full_add` and `te_combine`);
6. the window combine (kernel `te_combine`) and the exact TE->SW
   conversion of the single result on the host.

Routes not in this port yet raise NotImplementedError naming their queue
in ROADMAP.md: the m = 1 routes (no collapse; the 2^24+ scale regime),
the short-Weierstrass route (BLS12-381 G1) and the jittable batch forms.
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
from .accum_kernel import te_bucket_accumulate

_M1_ROUTE = ("the m = 1 MSM routes (no window collapse: the streamed and "
             "gather accumulate) are not ported yet: ROADMAP.md Queue 1, "
             "item 5")
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
    s = scalars.to(torch.int64)
    starts = torch.arange(n_win, device=s.device) * c
    i0, sh = starts // BASE_BITS, starts % BASE_BITS
    need = (n_win - 1) * c // BASE_BITS + 3
    if s.shape[-1] < need:
        s = torch.nn.functional.pad(s, (0, need - s.shape[-1]))
    word = s[:, i0] | (s[:, i0 + 1] << BASE_BITS) | (s[:, i0 + 2]
                                                      << 2 * BASE_BITS)
    raw = ((word >> sh) & ((1 << c) - 1)).t()              # (n_win, n)
    half = 1 << (c - 1)
    digits = torch.empty_like(raw)
    carry = torch.zeros_like(raw[0])
    for w in range(n_win):
        r = raw[w] + carry
        over = r >= half
        digits[w] = torch.where(over, r - (1 << c), r)
        carry = over.to(torch.int64)
    return digits


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
    TE conversion and the window-collapse table."""
    require_te(curve)
    if not collapse:
        raise NotImplementedError(_M1_ROUTE)
    n = points.x.shape[0]
    c, g, m = plan_collapse(curve, n, c, budget_bytes)
    if m == 1:
        raise NotImplementedError(f"plan (c={c}, g={g}, m=1): {_M1_ROUTE}")
    table = te_path.prepare_points_collapsed(
        curve, points.x, points.y, points.inf, c * g, m)
    return PreparedTe(table, c, g, m, n)


def msm(curve: CurveSpec, points: sw.Affine, scalars: torch.Tensor,
        c: int | None = None, prepared: PreparedTe | None = None
        ) -> sw.Point:
    """sum_i scalars[i] * points[i] for canonical scalar limb planes
    (n, L) (base 2^15, limbs < 2^15: the benchmark's compact form).
    Only points.inf is read when `prepared` is given."""
    require_te(curve)
    if prepared is None:
        prepared = prepare_points(curve, points, c)
    if prepared.m == 1:
        raise NotImplementedError(_M1_ROUTE)
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
