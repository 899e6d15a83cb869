"""A prover's KZG commitment: `kzg.commit` of one polynomial a call, its
coefficients already on the card in Montgomery form (a prover's
polynomials live there after its inverse NTT), over a test SRS of
2^srs_log powers of a tau drawn from the seed.

`distinct_sets` polynomials are drawn once; call k commits polynomial
k mod distinct_sets.  The coefficient words are drawn uniform in [0, r),
so the values they stand for, w·R^-1 mod r, are uniform in Fr."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import digits, generator
from ..reference import curve
from ..reference import kzg as ref
from . import sync

CONTROL_LOW_BITS = 16


class Entry:
    unit = "commit"
    route = "te_bucket_accumulate"

    def __init__(self, config, traffic, seed, device):
        self.srs_size = 1 << int(config["srs_log"])
        self.n = 1 << int(config["log_coefficients"])
        self.per_call = int(traffic["vectors_per_call"])
        self.sets = int(traffic["distinct_sets"])
        self.spec = traffic["scalars"]
        self.seed = seed
        self.device = device
        self.outputs = []
        self._k = 0
        self._canonical = {}

    def make_inputs(self):
        self.coeffs = torch.stack(list(generator.vectors(
            self.spec, self.n, self.sets * self.per_call, self.seed,
            self.device))).reshape(self.sets, self.per_call, self.n, -1)
        self.coeffs_host = self.coeffs.cpu().numpy()

    def init(self):
        from zprize_tpu_torch.curve.spec import BLS12_377_G1
        from zprize_tpu_torch.pcs import kzg
        sync(self.device)
        t0 = time.perf_counter()
        self.srs = kzg.setup_test_srs(BLS12_377_G1, self.srs_size,
                                      seed=self.seed, device=self.device)
        self._prepare()
        sync(self.device)
        self._kzg = kzg
        return time.perf_counter() - t0

    def _prepare(self):
        self.srs.prepared(self.srs.table_length(self.n))

    def call(self):
        k = self._k % self.sets
        self._k += 1
        pts = [self._kzg.commit(self.srs, c) for c in self.coeffs[k]]
        self.outputs.append((k, [tuple(a.numpy() for a in p) for p in pts]))
        return len(pts)

    def plan(self):
        p = self.srs.prepared(self.srs.table_length(self.n))
        return {"c": p.c, "g": p.g, "m": p.m, "n": p.n}

    def release(self):
        del self.srs, self.coeffs
        self._kzg = None

    def _polys(self, k):
        """The coefficient words of set k's polynomials, on the host."""
        return self.coeffs_host[k]

    def _expected(self, sets, low_bits=0):
        tau = ref.srs_tau(self.seed)
        return {k: [ref.expected(p, tau, low_bits) for p in self._polys(k)]
                for k in sets}

    def control(self):
        """The reference with each coefficient value's 16 low bits
        cleared: one call's outputs for each set."""
        exp = self._expected(range(self.sets), CONTROL_LOW_BITS)
        return list(exp.items())

    def check(self, outputs=None):
        outputs = self.outputs if outputs is None else outputs
        exp = self._expected(sorted({k for k, _ in outputs}))
        wrong = 0
        for k, got in outputs:
            got = [p if p is None or isinstance(p[0], int)
                   else curve.projective_ints(*p) for p in got]
            wrong += sum(g != e for g, e in zip(got, exp[k]))
            wrong += abs(len(exp[k]) - len(got))
        return {"wrong_commitments": (wrong, 0)}

    def _limbs(self, k):
        """The canonical values of set k's coefficients as (n, 17) limbs
        on the device."""
        if k not in self._canonical:
            r_inv = pow(1 << 256, -1, curve.R)
            raw = b"".join((w * r_inv % curve.R).to_bytes(32, "little")
                           for p in self._polys(k) for w in ref.raw_ints(p))
            words = np.frombuffer(raw, np.int32).reshape(-1, generator.WORDS)
            self._canonical[k] = generator.compact_limbs(
                torch.from_numpy(words.copy()).to(self.device))
        return self._canonical[k]

    def kernel_work(self, kernel):
        """The route kernel's rows and lanes over the window's calls."""
        if kernel != self.route:
            return None
        plan = self.plan()
        c = plan["c"]
        rows = sum(digits.nonzero_digits(self._limbs(k), c)
                   for k, _ in self.outputs)
        return rows, len(self.outputs) * self._lanes(plan)

    def _lanes(self, plan):
        return self.per_call * plan["g"] * (1 << (plan["c"] - 1))

