"""The eight MSM kernels, six twisted-Edwards and two short-Weierstrass:
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
| te_combine            | make_te_combine                                          |
| sw_gather_accumulate  | make_mixed_add, make_mixed_add_multi, make_mixed_add_rect (+ their rank loops) |
| sw_full_add           | make_full_add                                            |
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..curve import sw, te
from ..curve.spec import CurveSpec
from ..field import fp

TE_KERNELS = ("te_dbl_chain", "te_bucket_accumulate",
              "te_gather_accumulate", "te_full_add", "te_running_sum",
              "te_combine")
SW_KERNELS = ("sw_gather_accumulate", "sw_full_add")
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
    lib.sw_gather_accumulate.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ll,
                                         ll, ll, vp]
    lib.sw_full_add.argtypes = [vp, vp, vp, vp, ll, vp]
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


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _pt_tail(curve: CurveSpec, rows: int = 4) -> tuple:
    return (rows, fp.n_words(curve.field))


# ---------------------------------------------------------------------------
# te_dbl_chain
# ---------------------------------------------------------------------------


def te_dbl_chain(curve: CurveSpec, pts: torch.Tensor, n_dbls: int
                 ) -> torch.Tensor:
    """`n_dbls` sequential doublings of every point of pts (..., 4, nw)."""
    _check("pts", pts, _pt_tail(curve))
    if not _on_card(pts):
        return te_dbl_chain_plain(curve, pts, n_dbls)
    out = torch.empty_like(pts)
    n = pts.numel() // (4 * fp.n_words(curve.field))
    rc = _lib().te_dbl_chain(device_params(curve, pts.device).data_ptr(),
                             pts.data_ptr(), out.data_ptr(), n, n_dbls,
                             _stream(pts))
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
    if not _on_card(rows, sign, starts, counts):
        return te_bucket_accumulate_plain(curve, rows, sign, starts, counts)
    out = torch.empty((nbe, *_pt_tail(curve)), dtype=torch.int32,
                      device=rows.device)
    rc = _lib().te_bucket_accumulate(
        device_params(curve, rows.device).data_ptr(), rows.data_ptr(),
        sign.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        out.data_ptr(), nbe, _stream(rows))
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
    if not _on_card(table, perm, sign, starts, counts):
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
        n_win * nbe, _stream(table))
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
    if not _on_card(p, q, skip):
        return te_full_add_plain(curve, p, q, skip)
    out = torch.empty_like(p)
    n = p.numel() // (4 * fp.n_words(curve.field))
    rc = _lib().te_full_add(device_params(curve, p.device).data_ptr(),
                            p.data_ptr(), q.data_ptr(), skip.data_ptr(),
                            out.data_ptr(), n, _stream(p))
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
    if not _on_card(pts):
        return te_running_sum_plain(curve, pts)
    lanes, steps = pts.shape[:2]
    t_out = torch.empty_like(pts[:, 0])
    u_out = torch.empty_like(t_out)
    rc = _lib().te_running_sum(device_params(curve, pts.device).data_ptr(),
                               pts.data_ptr(), t_out.data_ptr(),
                               u_out.data_ptr(), lanes, steps, _stream(pts))
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
    if not _on_card(window_sums):
        return te_combine_plain(curve, window_sums, c)
    n_steps, lanes = window_sums.shape[:2]
    out = torch.empty_like(window_sums[0])
    rc = _lib().te_combine(device_params(curve, out.device).data_ptr(),
                           window_sums.data_ptr(), out.data_ptr(), n_steps,
                           lanes, c, _stream(out))
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
    if not _on_card(px, py, perm, sign, starts, counts):
        return sw_gather_accumulate_plain(curve, px, py, perm, sign, starts,
                                          counts)
    if px.data_ptr() % 16 or py.data_ptr() % 16:
        raise ValueError("px, py: the kernel reads 16-byte aligned rows")
    out = torch.empty((n_win, nbe, 3, nw), dtype=torch.int32,
                      device=px.device)
    rc = _sw_lib().sw_gather_accumulate(
        sw_params(curve, px.device).data_ptr(), px.data_ptr(), py.data_ptr(),
        perm.data_ptr(), sign.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), out.data_ptr(), px.shape[0], nbe, n_win * nbe,
        _stream(px))
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
    if not _on_card(acc, q, skip):
        return sw_full_add_plain(curve, acc, q, skip)
    rc = _sw_lib().sw_full_add(sw_params(curve, acc.device).data_ptr(),
                               acc.data_ptr(), q.data_ptr(), skip.data_ptr(),
                               skip.numel(), _stream(acc))
    _launch("sw_full_add", rc)
    return acc


def sw_full_add_plain(curve: CurveSpec, acc: torch.Tensor, q: torch.Tensor,
                      skip: torch.Tensor) -> torch.Tensor:
    s = sw.pack(sw.add(curve, sw.unpack(acc), sw.unpack(q)))
    return acc.copy_(torch.where((skip != 0)[..., None, None], acc, s))
