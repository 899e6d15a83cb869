"""The prize-1a call: `multi_scalar_mult` on a batch of scalar vectors
held in host memory, against a fixed point set prepared once.

Each of the n rows holds one of `distinct_points` points (j + 1)·G, the
row's class j drawn from the seed: the table holds n rows, so the work
and the bytes moved are those of n distinct points, and a row read in
another's place changes the result.  The scalar batch is drawn once from
the seed; every call multiplies the same batch and every MSM it returns
is held against the reference."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import digits, generator
from ..reference import curve
from ..reference import msm as ref
from . import sync

CONTROL_LOW_BITS = 16


class Entry:
    unit = "msm"

    def __init__(self, config, traffic, seed, device):
        self.n = 1 << int(config["log_points"])
        self.base = int(config["distinct_points"])
        self.vectors = int(traffic["vectors_per_call"])
        self.spec = traffic["scalars"]
        self.seed = seed
        self.device = device
        self.outputs = []

    def make_inputs(self):
        gen = generator.generator(self.seed, self.device)
        self.scalars = np.empty((self.vectors, self.n, generator.LIMBS),
                                np.uint16)
        for v in range(self.vectors):
            words = generator.draw(self.spec, self.n, gen, self.device)
            torch.from_numpy(self.scalars[v].view(np.int16)).copy_(
                generator.compact_limbs(words))
            del words
        classes = generator.point_classes(self.n, self.base, gen,
                                          self.device)
        pts = ref.base_points(self.base)
        self.xy = [torch.from_numpy(curve.ints_to_words(
            [p[k] for p in pts], curve.P, curve.FQ_WORDS)).to(
            self.device)[classes.to(torch.int64)] for k in (0, 1)]
        self.classes = classes.cpu().numpy()
        del classes

    def init(self):
        from zprize_tpu_torch.curve import sw
        from zprize_tpu_torch.curve.spec import BLS12_377_G1
        from zprize_tpu_torch.msm import api
        sync(self.device)
        t0 = time.perf_counter()
        aff = sw.Affine(*self.xy, torch.zeros(self.n, dtype=torch.bool,
                                              device=self.device))
        self.ctx = api.multi_scalar_mult_init(BLS12_377_G1, aff,
                                              device=self.device)
        del aff, self.xy
        sync(self.device)
        self._api = api
        return time.perf_counter() - t0

    def call(self):
        out = self._api.multi_scalar_mult(self.ctx, self.scalars)
        self.outputs.append([tuple(a.numpy() for a in p) for p in out])
        return len(out)

    def plan(self):
        p = self.ctx.prepared
        return {"c": p.c, "g": p.g, "m": p.m, "n": p.n}

    def release(self):
        del self.ctx
        self._api = None

    def _expected(self, low_bits=0):
        return [ref.expected(ref.weighted_limb_sums(
            s, self.classes, self.device, low_bits)) for s in self.scalars]

    def control(self):
        """The reference with each scalar's 16 low bits cleared: one
        call's outputs."""
        return [self._expected(CONTROL_LOW_BITS)]

    def check(self, outputs=None):
        outputs = self.outputs if outputs is None else outputs
        exp = self._expected()
        wrong = 0
        for call in outputs:
            got = [p if p is None or isinstance(p[0], int)
                   else curve.projective_ints(*p) for p in call]
            wrong += sum(g != e for g, e in zip(got, exp))
            wrong += abs(len(exp) - len(got))
        return {"wrong_msms": (wrong, 0)}

    def kernel_work(self, kernel):
        """te_gather_accumulate's rows and lanes over the window's calls
        of the m = 1 plan: the batch's nonzero digits, and every window's
        buckets, once a call."""
        plan = self.plan()
        if kernel != "te_gather_accumulate" or plan["m"] != 1:
            return None
        c = plan["c"]
        rows = sum(digits.nonzero_digits(
            torch.from_numpy(s.view(np.int16)).to(self.device), c)
            for s in self.scalars)
        calls = len(self.outputs)
        return calls * rows, calls * self.vectors * sum(
            digits.window_buckets(c))
