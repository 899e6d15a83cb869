"""A round of a batched prover's commitments: `kzg.commit_batch` of
`vectors_per_call` polynomials a call (as Marlin's `prove_batch` commits a
round for all its lanes), on the short-Weierstrass route.  The same
batch is committed every call."""

from __future__ import annotations

from . import kzg_commit


class Entry(kzg_commit.Entry):
    route = "sw_gather_accumulate"

    def _prepare(self):
        pass

    def call(self):
        k = self._k % self.sets
        self._k += 1
        pts = self._kzg.commit_batch(self.srs, self.coeffs[k])
        host = [a.cpu().numpy() for a in pts]
        self.outputs.append((k, [tuple(a[i] for a in host)
                                 for i in range(self.per_call)]))
        return self.per_call

    def plan(self):
        from zprize_tpu_torch.msm import pippenger
        return {"c": pippenger.default_window_bits(self.n), "n": self.n}

    def _lanes(self, plan):
        return self.per_call * sum(kzg_commit.digits.window_buckets(
            plan["c"]))
