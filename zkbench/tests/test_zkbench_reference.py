"""The plain reference against a slow Python-int MSM and commitment, its
controls against the reference, and its independence of the program."""

import ast
import os
import random

import numpy as np
import pytest

from zkbench import registry
from zkbench.reference import curve, kzg, msm

REF_DIR = os.path.join(registry.PKG, "reference")


def _slow_msm(points, scalars):
    acc = None
    for p, k in zip(points, scalars):
        acc = curve.add(acc, curve.mul(p, k))
    return acc


def _batch(values):
    return np.array([[(v >> (15 * i)) & 0x7FFF for i in range(17)]
                     for v in values], dtype=np.uint16)


@pytest.mark.parametrize("log_n,base", [(4, 4), (6, 16), (8, 64)])
def test_msm_against_slow_sum(log_n, base, monkeypatch):
    rng = random.Random(log_n)
    n = 1 << log_n
    vals = [rng.randrange(curve.R) for _ in range(n)]
    vals[:3] = [0, 1, curve.R - 1]
    classes = np.array([rng.randrange(base) for _ in range(n)], np.int16)
    pts = msm.base_points(base)
    assert pts[2] == curve.mul(curve.G, 3) and all(map(curve.on_curve, pts))
    rows = [pts[j] for j in classes]
    want = _slow_msm(rows, vals)
    batch = _batch(vals)
    # blocks of rows smaller than the batch, so their sums are carried
    monkeypatch.setattr(msm, "BLOCK_ROWS", 5)
    sums = msm.weighted_limb_sums(batch, classes, "cpu")
    assert msm.expected(sums) == want
    low = [v >> 16 << 16 for v in vals]
    ctl = msm.expected(msm.weighted_limb_sums(batch, classes, "cpu", 16))
    assert ctl == _slow_msm(rows, low) != want
    # a row read in another's place: row i given row i mod n/2's point
    half = [rows[i % (n // 2)] for i in range(n)]
    assert _slow_msm(half, vals) != want


def test_commitment_against_srs_sum():
    rng = random.Random(5)
    tau = kzg.srs_tau(2**31 + 3)
    n = 16
    coeffs = [rng.randrange(curve.R) for _ in range(n)]
    r_inv = pow(1 << 256, -1, curve.R)
    words = np.frombuffer(b"".join(c.to_bytes(32, "little") for c in coeffs),
                          np.int32).reshape(n, 8)
    srs = [curve.mul(curve.G, pow(tau, i, curve.R)) for i in range(n)]
    values = [c * r_inv % curve.R for c in coeffs]
    assert kzg.expected(words, tau) == _slow_msm(srs, values)
    low = [v >> 16 << 16 for v in values]
    assert kzg.expected(words, tau, 16) == _slow_msm(srs, low)


def test_words_round_trip():
    vals = [0, 1, curve.P - 1, 12345]
    w = curve.ints_to_words(vals, curve.P, 12)
    assert curve.words_to_ints(w, curve.P) == vals
    z = curve.ints_to_words([0], curve.P, 12)[0]
    one = curve.ints_to_words([1], curve.P, 12)[0]
    assert curve.projective_ints(one, one, z) is None
    g = curve.mul(curve.G, 7)
    zz = 987654321
    x, y, zw = (curve.ints_to_words([v * zz if k < 2 else zz], curve.P, 12)[0]
                for k, v in enumerate((*g, 0)))
    assert curve.projective_ints(x, y, zw) == g


def test_reference_imports_nothing_of_the_program():
    for f in os.listdir(REF_DIR):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(REF_DIR, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("__future__", "numpy", "random",
                                           "torch"), (
                    f"{f} imports {m}")
