"""The eleven MSM kernels, seven twisted-Edwards and four short-Weierstrass:
wrappers, launch counts and plain versions.

Each wrapper takes int32 Montgomery-word tensors (layouts in
``csrc/msm_te.cu``: TE points ``(L, 4, n_words)``, operand rows
``(R, 3, n_words)``; in ``csrc/msm_sw.cu``: SW points ``(L, 3, n_words)``,
affine coordinate planes ``(n, n_words)``), checks device, dtype, shape
and contiguity, and

* on CUDA tensors launches its hand-written kernel on the current stream,
  adds one to ``launches[name]``, and raises if the launch failed;
* on CPU tensors runs its plain version, the same op sequence vectorised
  over lanes in plain PyTorch (``curve/te.py`` or ``curve/sw.py`` on
  ``field/fp.py``).

The plain versions are public (``*_plain``) so that a run on the card can
hold each kernel against them bit for bit.

| wrapper               | TPU kernel it replaces (zprize_tpu/msm/accum_kernel.py) |
| --------------------- | -------------------------------------------------------- |
| te_dbl_chain          | make_te_dbl_chain                                        |
| te_bucket_accumulate  | make_te_mixed_add_slab (+ the loop of accumulate_te_sorted) |
| te_gather_accumulate  | make_te_mixed_add (+ the rank loop of accumulate_te_pallas) |
| te_full_add           | make_te_full_add                                         |
| te_running_sum        | the 2S make_te_full_add launches of merge_te_triangle_pallas |
| te_tree_sum           | the per-level make_te_full_add launches of the merges' trees |
| te_combine            | make_te_combine                                          |
| sw_gather_accumulate  | make_mixed_add, make_mixed_add_multi, make_mixed_add_rect (+ their rank loops) |
| sw_full_add           | make_full_add                                            |
| sw_running_sum        | the scan launches of make_full_add in merge_buckets_pallas |
| sw_combine            | the serial make_full_add launches of combine_windows (pippenger.py) and of the merge's fold |
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..curve import sw, te
from ..curve.spec import CurveSpec
from ..field import fp
from ..utils import device as _device

TE_KERNELS = ("te_dbl_chain", "te_bucket_accumulate",
              "te_gather_accumulate", "te_full_add", "te_running_sum",
              "te_tree_sum", "te_combine")
SW_KERNELS = ("sw_gather_accumulate", "sw_full_add", "sw_running_sum",
              "sw_combine")
# the curves' 3b for which csrc/msm_sw.cu has an instantiation (it
# multiplies by 3b as a chain of additions): BLS12-377's SW form, BLS12-381
SW_B3 = (3, 12)
KERNELS = TE_KERNELS + SW_KERNELS

# launches of each kernel since the last reset_launches()
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built from the checkout at first use."""
    from ..utils import build
    lib = build.load("msm_te")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.te_dbl_chain.argtypes = [vp, vp, vp, ll, ci, vp]
    lib.te_bucket_accumulate.argtypes = [vp, vp, vp, vp, vp, vp, ll, vp]
    lib.te_gather_accumulate.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ll,
                                         ll, vp]
    lib.te_full_add.argtypes = [vp, vp, vp, vp, vp, ll, vp]
    lib.te_running_sum.argtypes = [vp, vp, vp, vp, ll, ci, vp]
    lib.te_tree_sum.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ci, ci, ci,
                                vp]
    lib.te_combine.argtypes = [vp, vp, vp, ci, ll, ci, vp]
    for name in TE_KERNELS:
        getattr(lib, name).restype = ci
    lib.msm_te_error_string.argtypes = [ci]
    lib.msm_te_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sw_lib() -> ctypes.CDLL:
    """The SW kernel library, built from the checkout at first use."""
    from ..utils import build
    lib = build.load("msm_sw")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sw_gather_accumulate.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp,
                                         ll, ll, ll, vp]
    lib.sw_full_add.argtypes = [vp, ci, vp, vp, vp, ll, vp]
    lib.sw_running_sum.argtypes = [vp, ci, vp, vp, vp, ll, ci, vp]
    lib.sw_combine.argtypes = [vp, ci, vp, vp, ci, ll, ci, vp]
    for name in SW_KERNELS:
        getattr(lib, name).restype = ci
    lib.msm_sw_error_string.argtypes = [ci]
    lib.msm_sw_error_string.restype = ctypes.c_char_p
    return lib


def _params(f, k: int, device: torch.device) -> torch.Tensor:
    """The constants tensor of ``csrc/fq.cuh``: p, R mod p, R^2 mod p,
    the curve constant k (Montgomery form) and -p^-1 mod 2^32, as int32
    words."""
    mp = fp.montgomery_params(f)
    words = [fp.raw_words(f, mp["p"]), fp.raw_words(f, mp["one"]),
             fp.raw_words(f, mp["r2"]), fp.constant(f, k),
             torch.tensor([mp["n0"] - (1 << 32) * (mp["n0"] >> 31)],
                          dtype=torch.int32)]
    return torch.cat(words).to(device)


@functools.lru_cache(maxsize=None)
def device_params(curve: CurveSpec, device: torch.device) -> torch.Tensor:
    """The TE kernels' constants: k = 2d."""
    return _params(curve.field, te.te_params(curve).k, device)


@functools.lru_cache(maxsize=None)
def sw_params(curve: CurveSpec, device: torch.device) -> torch.Tensor:
    """The SW kernels' constants: k = 3b."""
    return _params(curve.field, curve.b3, device)


def _sw_b3(curve: CurveSpec) -> int:
    """The curve's 3b, which picks the SW kernels' instantiation; raises
    for a curve they have none for."""
    if curve.b3 not in SW_B3:
        raise ValueError(f"{curve.name}: the SW kernels take 3b in {SW_B3}, "
                         f"not {curve.b3}")
    return curve.b3



def _check(name: str, t: torch.Tensor, tail: tuple, dtype=torch.int32
           ) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape[t.dim() - len(tail):]) != tail or t.dim() < len(tail):
        raise ValueError(f"{name}: expected shape (..., "
                         f"{', '.join(map(str, tail))}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launch(name: str, rc: int) -> None:
    launches[name] += 1
    if rc != 0:
        lib = _sw_lib() if name.startswith("sw_") else _lib()
        err = getattr(lib, f"msm_{name[:2]}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: cuda error {rc} ({err})")


def _pt_tail(curve: CurveSpec, rows: int = 4) -> tuple:
    return (rows, fp.n_words(curve.field))


# ---------------------------------------------------------------------------
# te_dbl_chain
# ---------------------------------------------------------------------------


def te_dbl_chain(curve: CurveSpec, pts: torch.Tensor, n_dbls: int
                 ) -> torch.Tensor:
    """`n_dbls` sequential doublings of every point of pts (..., 4, nw)."""
    _check("pts", pts, _pt_tail(curve))
    if not _device.on_card(pts):
        return te_dbl_chain_plain(curve, pts, n_dbls)
    out = torch.empty_like(pts)
    n = pts.numel() // (4 * fp.n_words(curve.field))
    rc = _lib().te_dbl_chain(device_params(curve, pts.device).data_ptr(),
                             pts.data_ptr(), out.data_ptr(), n, n_dbls,
                             _device.stream(pts))
    _launch("te_dbl_chain", rc)
    return out


def te_dbl_chain_plain(curve: CurveSpec, pts: torch.Tensor, n_dbls: int
                       ) -> torch.Tensor:
    p = te.unpack(pts)
    for _ in range(n_dbls):
        p = te.dbl(curve, p)
    return te.pack(p)


# ---------------------------------------------------------------------------
# te_bucket_accumulate
# ---------------------------------------------------------------------------


def te_bucket_accumulate(curve: CurveSpec, rows: torch.Tensor,
                         sign: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Bucket sums over a bucket-sorted operand table.

    rows (R, 3, nw) holds the precomputed operands sorted by bucket, sign
    (R,) int32 marks operands to subtract, and bucket b is the run
    rows[starts[b] : starts[b] + counts[b]] (int64).  Returns the
    (nbe, 4, nw) extended sums, each starting from the identity."""
    _check("rows", rows, _pt_tail(curve, 3))
    if rows.dim() != 3:
        raise ValueError(f"rows: expected (R, 3, nw), got {tuple(rows.shape)}")
    _check("sign", sign, (rows.shape[0],))
    nbe = starts.shape[0]
    _check("starts", starts, (nbe,), torch.int64)
    _check("counts", counts, (nbe,), torch.int64)
    if not _device.on_card(rows, sign, starts, counts):
        return te_bucket_accumulate_plain(curve, rows, sign, starts, counts)
    out = torch.empty((nbe, *_pt_tail(curve)), dtype=torch.int32,
                      device=rows.device)
    rc = _lib().te_bucket_accumulate(
        device_params(curve, rows.device).data_ptr(), rows.data_ptr(),
        sign.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        out.data_ptr(), nbe, _device.stream(rows))
    _launch("te_bucket_accumulate", rc)
    return out


def te_bucket_accumulate_plain(curve: CurveSpec, rows: torch.Tensor,
                               sign: torch.Tensor, starts: torch.Tensor,
                               counts: torch.Tensor) -> torch.Tensor:
    """Rank-by-rank over all buckets up to the largest count; a bucket
    whose run has ended keeps its sum (a select, not an identity operand,
    so the projective result equals the kernel's walk)."""
    nbe = starts.shape[0]
    acc = te.identity(curve, (nbe,), rows.device)
    depth = int(counts.max()) if nbe else 0
    for r in range(depth):
        valid = r < counts
        pos = (starts + r).clamp(max=rows.shape[0] - 1)
        pre = te.select_neg_pre(curve, sign[pos] != 0,
                                te.unpack_pre(rows[pos]))
        acc = te.select(valid, te.add_mixed(curve, acc, pre), acc)
    return te.pack(acc)


# ---------------------------------------------------------------------------
# te_gather_accumulate
# ---------------------------------------------------------------------------


def te_gather_accumulate(curve: CurveSpec, table: torch.Tensor,
                         perm: torch.Tensor, sign: torch.Tensor,
                         starts: torch.Tensor, counts: torch.Tensor
                         ) -> torch.Tensor:
    """Bucket sums of W windows read through an index into the point
    table.

    table (n, 3, nw) holds one precomputed operand per point; perm (W, n)
    int64 lists, per window, the point indices sorted by bucket, and sign
    (W, n) int32 marks (in the same sorted order) the operands to
    subtract.  Bucket b of window w is the run perm[w, starts[w, b] :
    starts[w, b] + counts[w, b]] (starts, counts (W, nbe) int64).  Returns
    the (W, nbe, 4, nw) extended sums, each starting from the identity."""
    _check("table", table, _pt_tail(curve, 3))
    if table.dim() != 3:
        raise ValueError(f"table: expected (n, 3, nw), got "
                         f"{tuple(table.shape)}")
    if perm.dim() != 2 or starts.dim() != 2:
        raise ValueError(f"perm, starts: expected (W, n) and (W, nbe), got "
                         f"{tuple(perm.shape)} and {tuple(starts.shape)}")
    n_win, nbe = starts.shape
    _check("perm", perm, (n_win, table.shape[0]), torch.int64)
    _check("sign", sign, tuple(perm.shape))
    _check("starts", starts, (n_win, nbe), torch.int64)
    _check("counts", counts, (n_win, nbe), torch.int64)
    if not _device.on_card(table, perm, sign, starts, counts):
        return te_gather_accumulate_plain(curve, table, perm, sign, starts,
                                          counts)
    if table.data_ptr() % 16:
        raise ValueError("table: the kernel copies 16-byte aligned rows")
    out = torch.empty((n_win, nbe, *_pt_tail(curve)), dtype=torch.int32,
                      device=table.device)
    rc = _lib().te_gather_accumulate(
        device_params(curve, table.device).data_ptr(), table.data_ptr(),
        perm.data_ptr(), sign.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), out.data_ptr(), table.shape[0], nbe,
        n_win * nbe, _device.stream(table))
    _launch("te_gather_accumulate", rc)
    return out


def te_gather_accumulate_plain(curve: CurveSpec, table: torch.Tensor,
                               perm: torch.Tensor, sign: torch.Tensor,
                               starts: torch.Tensor, counts: torch.Tensor
                               ) -> torch.Tensor:
    """Rank-by-rank over all W * nbe bucket lanes, as
    te_bucket_accumulate_plain, with each rank's rows gathered through
    perm."""
    n_win, nbe = starts.shape
    acc = te.identity(curve, (n_win, nbe), table.device)
    depth = int(counts.max()) if counts.numel() else 0
    for r in range(depth):
        valid = r < counts
        pos = (starts + r).clamp(max=perm.shape[1] - 1)
        pre = te.select_neg_pre(curve, sign.gather(1, pos) != 0,
                                te.unpack_pre(table[perm.gather(1, pos)]))
        acc = te.select(valid, te.add_mixed(curve, acc, pre), acc)
    return te.pack(acc)


# ---------------------------------------------------------------------------
# te_full_add
# ---------------------------------------------------------------------------


def te_full_add(curve: CurveSpec, p: torch.Tensor, q: torch.Tensor,
                skip: torch.Tensor) -> torch.Tensor:
    """p + q per lane over (L, 4, nw); lanes with skip != 0 return p."""
    _check("p", p, _pt_tail(curve))
    _check("q", q, tuple(p.shape))
    _check("skip", skip, tuple(p.shape[:-2]))
    if not _device.on_card(p, q, skip):
        return te_full_add_plain(curve, p, q, skip)
    out = torch.empty_like(p)
    n = p.numel() // (4 * fp.n_words(curve.field))
    rc = _lib().te_full_add(device_params(curve, p.device).data_ptr(),
                            p.data_ptr(), q.data_ptr(), skip.data_ptr(),
                            out.data_ptr(), n, _device.stream(p))
    _launch("te_full_add", rc)
    return out


def te_full_add_plain(curve: CurveSpec, p: torch.Tensor, q: torch.Tensor,
                      skip: torch.Tensor) -> torch.Tensor:
    s = te.pack(te.add(curve, te.unpack(p), te.unpack(q)))
    return torch.where((skip != 0)[..., None, None], p, s)


# ---------------------------------------------------------------------------
# te_running_sum
# ---------------------------------------------------------------------------


def te_running_sum(curve: CurveSpec, pts: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both running sums of each lane's chunk: pts (L, S, 4, nw) holds
    lane l's S points B_0..B_{S-1}; returns (T, U), each (L, 4, nw), with
    T = sum_j B_j and U = sum_j (j+1) B_j, walked from the top
    (T = B_{S-1}, U = T; then T += B_j, U += T for j = S-2 .. 0)."""
    _check("pts", pts, _pt_tail(curve))
    if pts.dim() != 4 or pts.shape[1] < 1:
        raise ValueError("pts: expected (L, S >= 1, 4, nw), got "
                         f"{tuple(pts.shape)}")
    if not _device.on_card(pts):
        return te_running_sum_plain(curve, pts)
    lanes, steps = pts.shape[:2]
    t_out = torch.empty_like(pts[:, 0])
    u_out = torch.empty_like(t_out)
    rc = _lib().te_running_sum(device_params(curve, pts.device).data_ptr(),
                               pts.data_ptr(), t_out.data_ptr(),
                               u_out.data_ptr(), lanes, steps,
                               _device.stream(pts))
    _launch("te_running_sum", rc)
    return t_out, u_out


def te_running_sum_plain(curve: CurveSpec, pts: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    t = te.unpack(pts[:, -1])
    u = t
    for j in range(pts.shape[1] - 2, -1, -1):
        t = te.add(curve, t, te.unpack(pts[:, j]))
        u = te.add(curve, u, t)
    return te.pack(t), te.pack(u)


# ---------------------------------------------------------------------------
# te_tree_sum
# ---------------------------------------------------------------------------

# log2 of the slots a block of te_tree_sum's first pass sums
# (TREE_SEG_LOG of csrc/msm_te.cu, which checks it)
TREE_SEG_LOG = 6


def tree_bits(k: int, first: int) -> int:
    """How many bit sums weights first .. first + k - 1 have."""
    return max(1, (first + k - 1).bit_length())


def tree_layout(k: int, first: int | None) -> tuple[int, int, int]:
    """te_tree_sum's segments for k members at weight offset `first`
    (None: roots only): (segments, their count padded to a power of two,
    components a segment passes on: the root, and with bits the partials
    of bits 0 .. min(TREE_SEG_LOG, n_bits) - 1)."""
    off = first or 0
    n_seg = -(-(off + k) >> TREE_SEG_LOG)
    n_comp = (1 if first is None
              else 1 + min(TREE_SEG_LOG, tree_bits(k, off)))
    return n_seg, 1 << (n_seg - 1).bit_length(), n_comp


def te_tree_sum(curve: CurveSpec, pts: torch.Tensor, first: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Row sums of pts (R, K, 4, nw), (R, 4, nw); with a weight offset
    `first`, also the bit sums (n_bits, R, 4, nw): S_j[r] = the sum of the
    pts[r, m] whose weight first + m has bit j set, the identity where
    none has (n_bits = `tree_bits(K, first)`), else None.  The order of
    the adds is `te_tree_sum_plain`'s."""
    _check("pts", pts, _pt_tail(curve))
    if pts.dim() != 4 or pts.shape[1] < 1:
        raise ValueError("pts: expected (R, K >= 1, 4, nw), got "
                         f"{tuple(pts.shape)}")
    if first is not None and first < 0:
        raise ValueError(f"first: expected a weight offset >= 0, got {first}")
    if not _device.on_card(pts):
        return te_tree_sum_plain(curve, pts, first)
    rows, k = pts.shape[:2]
    off = first or 0
    n_bits = tree_bits(k, off)
    _, n_pow, n_comp = tree_layout(k, first)
    sums = torch.empty_like(pts[:, 0])
    bits = (None if first is None else
            torch.empty((n_bits, *sums.shape), dtype=torch.int32,
                        device=pts.device))
    seg = torch.empty((rows, n_comp, n_pow, *pts.shape[-2:]),
                      dtype=torch.int32, device=pts.device)
    flags = torch.empty((rows, n_comp, n_pow), dtype=torch.int32,
                        device=pts.device)
    rc = _lib().te_tree_sum(
        device_params(curve, pts.device).data_ptr(), pts.data_ptr(),
        seg.data_ptr(), flags.data_ptr(), sums.data_ptr(),
        None if bits is None else bits.data_ptr(), rows, k, off, n_bits,
        TREE_SEG_LOG, _device.stream(pts))
    _launch("te_tree_sum", rc)
    return sums, bits


def _tree_upsweep(curve: CurveSpec, *groups: tuple) -> None:
    """The in-place up-sweep of each group (x, present, bits): x (rows, n,
    4, nw), n a power of two and the same for every group, present (rows,
    n) bool.  At step t the level-t nodes pair up, L = 2j 2^t, R = L +
    2^t, and x[L] += x[R]; with `bits` also x[L + 2^b] += x[R + 2^b] for b
    < t.  An absent right leaves the left, an absent left takes the right.
    Afterwards x[0] is the sum and x[2^b] the sum of the positions with b
    trailing zeros.  Only pairs with both sides present are added, those
    of all groups in one `te.add` a step."""
    n = groups[0][0].shape[1]
    for t in range(n.bit_length() - 1):
        steps = []
        for x, present, bits in groups:
            offs = [0] + ([1 << b for b in range(t)] if bits else [])
            left = torch.arange(0, n, 2 << t, device=x.device)
            li = (left[:, None]
                  + torch.tensor(offs, device=x.device)).reshape(-1)
            ri = li + (1 << t)
            a, b = x[:, li], x[:, ri]
            pl, pr = present[:, li], present[:, ri]
            both = pl & pr
            steps.append((x, present, li, a, b, pl | pr, both,
                          torch.where(pr[..., None, None], b, a)))
        lhs = torch.cat([st[3][st[6]] for st in steps])
        if lhs.shape[0]:
            rhs = torch.cat([st[4][st[6]] for st in steps])
            s = te.pack(te.add(curve, te.unpack(lhs), te.unpack(rhs)))
            parts = s.split([int(st[6].sum()) for st in steps])
            for st, part in zip(steps, parts):
                st[7][st[6]] = part
        for x, present, li, _, _, p, _, new in steps:
            x[:, li] = new
            present[:, li] = p


def te_tree_sum_plain(curve: CurveSpec, pts: torch.Tensor,
                      first: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel's order: member m of a row in slot off + m (off = first,
    or 0), the slots cut into segments of 2^TREE_SEG_LOG (absent slots
    before and after); `_tree_upsweep` over each segment (with bits when
    `first` is given), whose components are the root x[0] and the bit-b
    partials x[2^b]; then, per row, `_tree_upsweep` over the segments'
    roots (with bits: the bits above the segment, at positions 2^b) and
    apart over each bit's partials (no bits), the segments padded with
    absent ones to a power of two."""
    rows, k = pts.shape[:2]
    off = first or 0
    with_bits = first is not None
    n_bits = tree_bits(k, off)
    seg = 1 << TREE_SEG_LOG
    n_seg, n_pow, n_comp = tree_layout(k, first)
    x = torch.zeros((rows, n_seg * seg, *pts.shape[-2:]), dtype=pts.dtype,
                    device=pts.device)
    x[:, off:off + k] = pts
    present = torch.zeros(x.shape[:2], dtype=torch.bool, device=pts.device)
    present[:, off:off + k] = True
    x = x.reshape(rows * n_seg, seg, *pts.shape[-2:])
    present = present.reshape(rows * n_seg, seg)
    _tree_upsweep(curve, (x, present, with_bits))
    pos = [0] + [1 << b for b in range(n_comp - 1)]
    # (rows, n_comp, n_pow): component c of segment s at [:, c, s]
    y = torch.zeros((rows, n_comp, n_pow, *pts.shape[-2:]), dtype=pts.dtype,
                    device=pts.device)
    yp = torch.zeros((rows, n_comp, n_pow), dtype=torch.bool,
                     device=pts.device)
    y[:, :, :n_seg] = x[:, pos].reshape(rows, n_seg, n_comp,
                                        *pts.shape[-2:]).transpose(1, 2)
    yp[:, :, :n_seg] = present[:, pos].reshape(rows, n_seg,
                                               n_comp).transpose(1, 2)
    roots, roots_p = y[:, 0].clone(), yp[:, 0].clone()
    if not with_bits:
        _tree_upsweep(curve, (roots, roots_p, False))
        return roots[:, 0], None
    parts = y[:, 1:].reshape(rows * (n_comp - 1), n_pow, *pts.shape[-2:])
    parts_p = yp[:, 1:].reshape(rows * (n_comp - 1), n_pow)
    _tree_upsweep(curve, (roots, roots_p, True), (parts, parts_p, False))
    sums = roots[:, 0]
    parts = parts[:, 0].reshape(rows, n_comp - 1, *pts.shape[-2:])
    parts_p = parts_p[:, 0].reshape(rows, n_comp - 1)
    ident = te.pack(te.identity(curve, (), pts.device))
    out = []
    for j in range(n_bits):
        if j < TREE_SEG_LOG:
            v, p = parts[:, j], parts_p[:, j]
        elif (1 << (j - TREE_SEG_LOG)) < n_pow:
            v, p = (roots[:, 1 << (j - TREE_SEG_LOG)],
                    roots_p[:, 1 << (j - TREE_SEG_LOG)])
        else:
            v, p = ident.expand(rows, *ident.shape), torch.zeros(
                rows, dtype=torch.bool, device=pts.device)
        out.append(torch.where(p[:, None, None], v, ident))
    return sums, torch.stack(out)


# ---------------------------------------------------------------------------
# te_combine
# ---------------------------------------------------------------------------


def te_combine(curve: CurveSpec, window_sums: torch.Tensor, c: int
               ) -> torch.Tensor:
    """sum_w 2^(c*w) * W_w per lane, MSB-first: window_sums (S, L, 4, nw)
    -> (L, 4, nw)."""
    _check("window_sums", window_sums, _pt_tail(curve))
    if window_sums.dim() != 4 or window_sums.shape[0] < 1:
        raise ValueError("window_sums: expected (S >= 1, L, 4, nw), got "
                         f"{tuple(window_sums.shape)}")
    if not _device.on_card(window_sums):
        return te_combine_plain(curve, window_sums, c)
    n_steps, lanes = window_sums.shape[:2]
    out = torch.empty_like(window_sums[0])
    rc = _lib().te_combine(device_params(curve, out.device).data_ptr(),
                           window_sums.data_ptr(), out.data_ptr(), n_steps,
                           lanes, c, _device.stream(out))
    _launch("te_combine", rc)
    return out


def te_combine_plain(curve: CurveSpec, window_sums: torch.Tensor, c: int
                     ) -> torch.Tensor:
    acc = te.unpack(window_sums[-1])
    for w in range(window_sums.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = te.dbl(curve, acc)
        acc = te.add(curve, acc, te.unpack(window_sums[w]))
    return te.pack(acc)


# ---------------------------------------------------------------------------
# sw_gather_accumulate
# ---------------------------------------------------------------------------


def sw_gather_accumulate(curve: CurveSpec, px: torch.Tensor,
                         py: torch.Tensor, perm: torch.Tensor,
                         sign: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """SW bucket sums of W windows read through an index into the affine
    coordinate planes.

    px, py (n, nw) hold the points; perm (W, n) int64 lists, per window,
    the point indices sorted by bucket, and sign (W, n) int32 marks (in
    the same sorted order) the points to subtract.  Bucket b of window w
    is the run perm[w, starts[w, b] : starts[w, b] + counts[w, b]]
    (starts, counts (W, nbe) int64).  Returns the (W, nbe, 3, nw)
    projective sums, each starting from the identity (0 : 1 : 0)."""
    nw = fp.n_words(curve.field)
    _check("px", px, (nw,))
    if px.dim() != 2:
        raise ValueError(f"px: expected (n, {nw}), got {tuple(px.shape)}")
    _check("py", py, tuple(px.shape))
    if perm.dim() != 2 or starts.dim() != 2:
        raise ValueError(f"perm, starts: expected (W, n) and (W, nbe), got "
                         f"{tuple(perm.shape)} and {tuple(starts.shape)}")
    n_win, nbe = starts.shape
    _check("perm", perm, (n_win, px.shape[0]), torch.int64)
    _check("sign", sign, tuple(perm.shape))
    _check("starts", starts, (n_win, nbe), torch.int64)
    _check("counts", counts, (n_win, nbe), torch.int64)
    if not _device.on_card(px, py, perm, sign, starts, counts):
        return sw_gather_accumulate_plain(curve, px, py, perm, sign, starts,
                                          counts)
    if px.data_ptr() % 16 or py.data_ptr() % 16:
        raise ValueError("px, py: the kernel reads 16-byte aligned rows")
    out = torch.empty((n_win, nbe, 3, nw), dtype=torch.int32,
                      device=px.device)
    rc = _sw_lib().sw_gather_accumulate(
        sw_params(curve, px.device).data_ptr(), _sw_b3(curve), px.data_ptr(),
        py.data_ptr(),
        perm.data_ptr(), sign.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), out.data_ptr(), px.shape[0], nbe, n_win * nbe,
        _device.stream(px))
    _launch("sw_gather_accumulate", rc)
    return out


def sw_accumulate_ranks(curve: CurveSpec, px: torch.Tensor, py: torch.Tensor,
                        perm: torch.Tensor, sign: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        rank0: int, cap: int) -> sw.Point:
    """Ranks rank0 .. rank0 + cap - 1 of every bucket run (arguments as
    `sw_gather_accumulate`), rank by rank over all W * nbe lanes on the
    plain engine: each rank gathers one point per lane through perm and
    takes one complete mixed add, and a lane whose run has ended (or not
    begun) keeps its sum (the point's inf flag, not an identity operand,
    so the projective result equals the kernel's walk)."""
    f = curve.field
    acc = sw.identity(curve, tuple(starts.shape), px.device)
    for r in range(rank0, rank0 + cap):
        valid = r < counts
        pos = (starts + r).clamp(max=perm.shape[1] - 1)
        idx = perm.gather(1, pos)
        ay = py[idx]
        ay = fp.select(sign.gather(1, pos) != 0, fp.neg(f, ay), ay)
        acc = sw.add_mixed(curve, acc, sw.Affine(px[idx], ay, ~valid))
    return acc


def sw_gather_accumulate_plain(curve: CurveSpec, px: torch.Tensor,
                               py: torch.Tensor, perm: torch.Tensor,
                               sign: torch.Tensor, starts: torch.Tensor,
                               counts: torch.Tensor) -> torch.Tensor:
    """Every rank of every run (`sw_accumulate_ranks` up to the largest
    count), packed as the kernel's output."""
    depth = int(counts.max()) if counts.numel() else 0
    return sw.pack(sw_accumulate_ranks(curve, px, py, perm, sign, starts,
                                       counts, 0, depth))


# ---------------------------------------------------------------------------
# sw_full_add
# ---------------------------------------------------------------------------


def sw_full_add(curve: CurveSpec, acc: torch.Tensor, q: torch.Tensor,
                skip: torch.Tensor) -> torch.Tensor:
    """acc += q per lane over (L, 3, nw), in place (q may be acc itself: a
    doubling); lanes with skip != 0 keep acc.  Returns acc."""
    _check("acc", acc, (3, fp.n_words(curve.field)))
    _check("q", q, tuple(acc.shape))
    _check("skip", skip, tuple(acc.shape[:-2]))
    if not _device.on_card(acc, q, skip):
        return sw_full_add_plain(curve, acc, q, skip)
    rc = _sw_lib().sw_full_add(sw_params(curve, acc.device).data_ptr(),
                               _sw_b3(curve), acc.data_ptr(), q.data_ptr(),
                               skip.data_ptr(), skip.numel(),
                               _device.stream(acc))
    _launch("sw_full_add", rc)
    return acc


def sw_full_add_plain(curve: CurveSpec, acc: torch.Tensor, q: torch.Tensor,
                      skip: torch.Tensor) -> torch.Tensor:
    s = sw.pack(sw.add(curve, sw.unpack(acc), sw.unpack(q)))
    return acc.copy_(torch.where((skip != 0)[..., None, None], acc, s))


# ---------------------------------------------------------------------------
# sw_running_sum
# ---------------------------------------------------------------------------


def sw_running_sum(curve: CurveSpec, pts: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both running sums of each lane's chunk: pts (L, S, 3, nw) holds
    lane l's S points B_0..B_{S-1}; returns (T, U), each (L, 3, nw), with
    T = sum_j B_j and U = sum_j (j+1) B_j, walked from the top
    (T = B_{S-1}, U = T; then T += B_j, U += T for j = S-2 .. 0)."""
    _check("pts", pts, (3, fp.n_words(curve.field)))
    if pts.dim() != 4 or pts.shape[1] < 1:
        raise ValueError("pts: expected (L, S >= 1, 3, nw), got "
                         f"{tuple(pts.shape)}")
    if not _device.on_card(pts):
        return sw_running_sum_plain(curve, pts)
    lanes, steps = pts.shape[:2]
    t_out = torch.empty_like(pts[:, 0])
    u_out = torch.empty_like(t_out)
    rc = _sw_lib().sw_running_sum(sw_params(curve, pts.device).data_ptr(),
                                  _sw_b3(curve), pts.data_ptr(),
                                  t_out.data_ptr(), u_out.data_ptr(), lanes,
                                  steps, _device.stream(pts))
    _launch("sw_running_sum", rc)
    return t_out, u_out


def sw_running_sum_plain(curve: CurveSpec, pts: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    t = sw.unpack(pts[:, -1])
    u = t
    for j in range(pts.shape[1] - 2, -1, -1):
        t = sw.add(curve, t, sw.unpack(pts[:, j]))
        u = sw.add(curve, u, t)
    return sw.pack(t), sw.pack(u)


# ---------------------------------------------------------------------------
# sw_combine
# ---------------------------------------------------------------------------


def sw_combine(curve: CurveSpec, window_sums: torch.Tensor, c: int
               ) -> torch.Tensor:
    """sum_w 2^(c*w) * W_w per lane, MSB-first: window_sums (S, L, 3, nw)
    -> (L, 3, nw); c doublings (`sw.dbl_a0`) and one complete add a
    step."""
    _check("window_sums", window_sums, (3, fp.n_words(curve.field)))
    if window_sums.dim() != 4 or window_sums.shape[0] < 1:
        raise ValueError("window_sums: expected (S >= 1, L, 3, nw), got "
                         f"{tuple(window_sums.shape)}")
    if not _device.on_card(window_sums):
        return sw_combine_plain(curve, window_sums, c)
    n_steps, lanes = window_sums.shape[:2]
    out = torch.empty_like(window_sums[0])
    rc = _sw_lib().sw_combine(sw_params(curve, out.device).data_ptr(),
                              _sw_b3(curve), window_sums.data_ptr(),
                              out.data_ptr(), n_steps, lanes, c,
                              _device.stream(out))
    _launch("sw_combine", rc)
    return out


def sw_combine_plain(curve: CurveSpec, window_sums: torch.Tensor, c: int
                     ) -> torch.Tensor:
    acc = sw.unpack(window_sums[-1])
    for w in range(window_sums.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = sw.dbl_a0(curve, acc)
        acc = sw.add(curve, acc, sw.unpack(window_sums[w]))
    return sw.pack(acc)
