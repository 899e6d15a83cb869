"""The port's Goldilocks NTT (zprize_tpu_torch/ntt/{gl_ops,gl_kernel,fourstep})
against the reference package's `gl_ops`, `gl_kernel` (its Pallas kernels
in interpret mode) and `fourstep`, and against python ints, on the CPU,
where `gl_ntt` runs its plain version (the hand-written kernel is held
against that plain version on the card by chip_smoke.py, phases 3c and 8).
Exact: every value compares as a canonical int (tolerance 0)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_tpu.field import fp as ref_fp
from zprize_tpu.field.spec import GOLDILOCKS as REF_GL
from zprize_tpu.ntt import fourstep as ref_fourstep
from zprize_tpu.ntt import gl_kernel as ref_gk
from zprize_tpu.ntt import gl_ops as ref_gops
from zprize_tpu_torch import convert
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.field.spec import GOLDILOCKS as GL
from zprize_tpu_torch.ntt import fourstep, gl_kernel, gl_ops, radix2
from zprize_tpu_torch.ntt.domain import Domain, gl_powers, primitive_root
from zprize_tpu_torch.utils.oracle import dft_ints, ntt_ints
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

Q = gl_ops.Q
# the edge values of tests/test_gl_kernel.py, some at or above q (the
# reference's planes may hold any value below 2^64)
EDGES = [0, 1, Q - 1, Q - 2, (1 << 64) - 1, 1 << 32, (1 << 32) - 1, Q, Q + 5]


def _lazy_values(count, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(1 << 64) for _ in range(count)]
    vals[:len(EDGES)] = EDGES[:count]
    return vals


def _planes(vals):
    """Python ints below 2^64 -> the reference's (lo, hi) numpy u32."""
    arr = np.asarray(vals, dtype=object)
    return ((arr & 0xFFFFFFFF).astype(np.uint32),
            (arr >> 32).astype(np.uint32))


def _ref_ints(lo, hi):
    """Reference planes -> canonical ints (its own gl_canon first)."""
    lo, hi = ref_gops.gl_canon(jnp.asarray(lo), jnp.asarray(hi))
    lo = np.asarray(lo, np.uint64)
    hi = np.asarray(hi, np.uint64)
    return [int(v) for v in (lo | (hi << np.uint64(32))).reshape(-1)]


def _columns(log_n, b, seed):
    """(n, B) lazily reduced ints, as a list of rows."""
    flat = _lazy_values((1 << log_n) * b, seed)
    return [flat[i * b:(i + 1) * b] for i in range(1 << log_n)]


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's Pallas NTTs in interpret mode, three calls in all:
    ntt_packed at 2^8 x 2 forward and inverse, ntt_fourstep_packed(5, 5)."""
    rows = _columns(8, 2, 5)
    lo, hi = _planes(rows)
    flo, fhi = ref_gk.ntt_packed(8, jnp.asarray(lo), jnp.asarray(hi),
                                 interpret=True, tile=2)
    ilo, ihi = ref_gk.ntt_packed(8, jnp.asarray(lo), jnp.asarray(hi),
                                 inverse=True, interpret=True, tile=2)
    vec = _lazy_values(1 << 10, 6)
    vlo, vhi = _planes(vec)
    slo, shi = ref_gk.ntt_fourstep_packed(5, 5, jnp.asarray(vlo),
                                          jnp.asarray(vhi), interpret=True)
    return {"rows": (lo, hi), "forward": _ref_ints(flo, fhi),
            "inverse": _ref_ints(ilo, ihi), "vec": (vlo, vhi),
            "fourstep": _ref_ints(slo, shi)}


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_gl_ops_match_reference_and_ints(name):
    a = _lazy_values(120, 1)
    b = a[::-1]
    ours = getattr(gl_ops, f"gl_{name}")
    theirs = getattr(ref_gops, f"gl_{name}")
    exact = {"add": lambda x, y: (x + y) % Q, "sub": lambda x, y: (x - y) % Q,
             "mul": lambda x, y: x * y % Q}[name]
    got = gl_ops.to_ints(ours(convert.gl_from_reference(*_planes(a), "cpu"),
                              convert.gl_from_reference(*_planes(b), "cpu")))
    alo, ahi = _planes(a)
    blo, bhi = _planes(b)
    ref = _ref_ints(*theirs(jnp.asarray(alo), jnp.asarray(ahi),
                            jnp.asarray(blo), jnp.asarray(bhi)))
    assert got == ref == [exact(x, y) for x, y in zip(a, b)]


def test_canon_and_planes_round_trip():
    vals = _lazy_values(64, 2)
    lo, hi = _planes(vals)
    x = convert.gl_from_reference(lo, hi, "cpu")
    assert gl_ops.to_ints(x) == _ref_ints(lo, hi) == [v % Q for v in vals]
    assert gl_ops.to_ints(gl_ops.gl_canon(torch.from_numpy(
        np.asarray(vals, np.uint64).view(np.int64)))) == [v % Q for v in vals]
    back = convert.gl_to_reference(x)
    clo, chi = ref_gops.gl_canon(jnp.asarray(lo), jnp.asarray(hi))
    assert np.array_equal(back[0], np.asarray(clo))
    assert np.array_equal(back[1], np.asarray(chi))
    plo, phi = gl_ops.to_planes(x)
    assert torch.equal(gl_ops.from_planes(plo, phi), x)


def test_montgomery_word_conversions():
    rng = random.Random(3)
    xs = [rng.randrange(Q) for _ in range(40)] + [0, 1, Q - 1]
    words = fp.from_ints(GL, xs)
    x = gl_ops.from_words(words)
    assert gl_ops.to_ints(x) == xs
    assert torch.equal(gl_ops.to_words(x), words)
    # the reference's own conversion from its limb planes
    lo, hi = ref_gops.from_limbs(REF_GL, ref_fp.from_ints(REF_GL, xs))
    assert torch.equal(convert.gl_from_reference(np.asarray(lo),
                                                 np.asarray(hi), "cpu"), x)
    back = ref_gops.to_limbs(REF_GL, *map(jnp.asarray,
                                          convert.gl_to_reference(x)))
    assert [int(v) for v in ref_fp.to_ints(REF_GL, back)] == xs


def test_gl_power_tables_match_montgomery_tables_and_ints():
    """The u64 tables beside the Montgomery ones (which test_torch_ntt
    holds against the reference's)."""
    for log_n in (0, 1, 4, 7):
        dom = Domain(GL, log_n, "cpu")
        for inverse, pows in ((False, dom.pows), (True, dom.pows_inv)):
            w = dom.w_inv if inverse else dom.w
            got = gl_ops.to_ints(gl_powers(log_n, inverse, "cpu"))
            assert got == [int(v) for v in fp.to_ints(GL, pows)]
            assert got == [pow(w, k, Q) for k in range(max(1, dom.n // 2))]
    assert gl_powers(3, device="cpu") is gl_powers(3, False,
                                                   torch.device("cpu"))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_ntt_packed_matches_reference(reference_runs, inverse):
    """2^8 x 2, in the reference's fused-kernel range, from its lazily
    reduced planes carried across with gl_from_reference."""
    x = convert.gl_from_reference(*reference_runs["rows"], "cpu")
    out = gl_kernel.ntt_packed(8, x, inverse, "cpu")
    key = "inverse" if inverse else "forward"
    assert gl_ops.to_ints(out) == reference_runs[key]
    lo, hi = convert.gl_to_reference(out)
    assert _ref_ints(lo, hi) == reference_runs[key]
    back = gl_kernel.ntt_packed(8, out, not inverse, "cpu")
    assert torch.equal(back, x)


def test_fourstep_packed_matches_reference(reference_runs):
    x = convert.gl_from_reference(*reference_runs["vec"], "cpu")
    out = gl_kernel.ntt_fourstep_packed(5, 5, x, "cpu")
    assert gl_ops.to_ints(out) == reference_runs["fourstep"]
    assert torch.equal(out, gl_kernel.ntt_fourstep_packed(3, 7, x, "cpu"))


def test_generic_fourstep_matches_reference():
    rng = random.Random(7)
    xs = [rng.randrange(Q) for _ in range(1 << 10)]
    ref = ref_fourstep.ntt_fourstep(REF_GL, ref_fp.from_ints(REF_GL, xs),
                                    5, 5)
    expect = [int(v) for v in ref_fp.to_ints(REF_GL, ref)]
    a = fp.from_ints(GL, xs)
    out = fourstep.ntt_fourstep(GL, a, 5, 5, "cpu")
    assert [int(v) for v in fp.to_ints(GL, out)] == expect
    back = fourstep.intt_fourstep(GL, out, 5, 5, "cpu")
    assert torch.equal(back, a)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_ntt_packed_recursion_matches_python_ints(inverse):
    """2^13 x 2 with the tile forced down to 2^4: three four-step levels
    (13 -> 4 + 9 -> 4 + 5 -> 2 + 3)."""
    log_n, b = 13, 2
    rng = random.Random(8 + inverse)
    cols = [[rng.randrange(Q) for _ in range(1 << log_n)] for _ in range(b)]
    x = gl_ops.from_ints([list(r) for r in zip(*cols)])
    out = gl_kernel.ntt_packed(log_n, x, inverse, "cpu", _tile_log=4)
    w = primitive_root(GL, log_n)
    scale = 1
    if inverse:
        w, scale = pow(w, -1, Q), pow(1 << log_n, -1, Q)
    expect = [[v * scale % Q for v in ntt_ints(c, w, Q)] for c in cols]
    assert gl_ops.to_ints(out) == [v for r in zip(*expect) for v in r]


def test_gl_ntt_step_twiddle_and_scale_match_python_ints():
    """The column pass of a four-step level: NTT of each column, element
    (k1, col) times w_N^(k1 * (col // inner)), then a scale."""
    log_n, step_log, inner = 3, 9, 2          # N = 2^12, two-level tables
    n, b = 1 << log_n, inner << step_log
    rng = random.Random(9)
    rows = [[rng.randrange(Q) for _ in range(b)] for _ in range(n)]
    x = gl_ops.from_ints(rows)
    scale = rng.randrange(Q)
    for inverse in (False, True):
        out = gl_kernel.gl_ntt(x, log_n, inverse, step_log, inner, scale)
        w, wn = primitive_root(GL, log_n), primitive_root(GL, log_n + step_log)
        if inverse:
            w, wn = pow(w, -1, Q), pow(wn, -1, Q)
        cols = [dft_ints([rows[i][c] for i in range(n)], w, Q)
                for c in range(b)]
        expect = [cols[c][k] * pow(wn, k * (c // inner), Q) * scale % Q
                  for k in range(n) for c in range(b)]
        assert gl_ops.to_ints(out) == expect


def test_radix2_on_a_goldilocks_domain_matches_python_ints():
    dom = Domain(GL, 5, "cpu")
    rng = random.Random(10)
    rows = [[rng.randrange(Q) for _ in range(dom.n)] for _ in range(3)]
    rows[0][:3] = [0, 1, Q - 1]
    a = fp.from_ints(GL, rows)
    fwd = radix2.ntt(dom, a)
    assert [int(v) for v in fp.to_ints(GL, fwd).reshape(-1)] == [
        v for r in rows for v in dft_ints(r, dom.w, Q)]
    assert torch.equal(radix2.intt(dom, fwd), a)
    along0 = radix2.ntt(dom, a.transpose(0, 1), axis=0)
    assert torch.equal(along0, fwd.transpose(0, 1))


def test_wrapper_checks_its_input():
    x = torch.zeros((8, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        gl_kernel.gl_ntt(x.to(torch.int32), 3)
    with pytest.raises(ValueError, match="expected"):
        gl_kernel.gl_ntt(x, 4)
    with pytest.raises(ValueError, match="2\\^0..2\\^12"):
        gl_kernel.gl_ntt(torch.zeros((1 << 13, 1), dtype=torch.int64), 13)
    with pytest.raises(ValueError, match="contiguous"):
        gl_kernel.gl_ntt(torch.zeros((2, 8), dtype=torch.int64).t(), 3)
    with pytest.raises(ValueError, match="columns"):
        gl_kernel.gl_ntt(x, 3, step_log=2)
    with pytest.raises(ValueError, match="unsupported device"):
        gl_kernel.gl_ntt(torch.empty((8, 2), dtype=torch.int64,
                                     device="meta"), 3)
    with pytest.raises(ValueError, match="column pass"):
        gl_kernel.ntt_fourstep_packed(13, 1, torch.zeros(1 << 14,
                                                         dtype=torch.int64),
                                      "cpu")
    with pytest.raises(TypeError):
        gl_kernel.ntt_packed(3, np.zeros((8, 1), np.int64), device="cpu")
    with pytest.raises(ValueError, match="domain tables"):
        radix2.ntt(Domain(GL, 3, "cpu"),
                   torch.empty((8, 2), dtype=torch.int32, device="meta"))
