"""R1CS constraint systems (host-side build, device proving).

The arithmetization source format of the reference's Marlin tracks
(snarkVM `algorithms/src/snark/marlin/ahp/indexer/`, constraint synthesis in
`dpc/src/posw/circuit.rs`): three sparse matrices A, B, C over Fr with
(A z) o (B z) = (C z) for the full assignment z = (x || w).

Conventions:
* variable 0 is the constant ONE (so linear combinations carry constants);
* variables [0, num_public) are public (x), the rest witness (w);
* matrices are lists of (row, col, coeff) entries, host ints.
"""

from __future__ import annotations

import dataclasses

from ..field.spec import FieldSpec


@dataclasses.dataclass
class R1CS:
    spec: FieldSpec
    num_public: int                  # includes the leading constant-1
    num_vars: int
    a: list                          # [(row, col, coeff)]
    b: list
    c: list
    num_constraints: int

    def is_satisfied(self, z: list[int]) -> bool:
        p = self.spec.p
        assert len(z) == self.num_vars and z[0] == 1

        def matvec(entries):
            out = [0] * self.num_constraints
            for r, c, v in entries:
                out[r] = (out[r] + v * z[c]) % p
            return out

        az, bz, cz = matvec(self.a), matvec(self.b), matvec(self.c)
        return all(az[i] * bz[i] % p == cz[i] for i in
                   range(self.num_constraints))


class R1CSBuilder:
    """Minimal constraint-synthesis surface (the role of snarkVM's
    `ConstraintSystem` trait): allocate variables, add constraints as
    linear-combination triples."""

    def __init__(self, spec: FieldSpec, num_public: int):
        self.spec = spec
        self.num_public = num_public + 1       # + constant ONE at index 0
        self.num_vars = self.num_public
        self.a: list = []
        self.b: list = []
        self.c: list = []
        self.n_rows = 0

    @property
    def one(self) -> int:
        return 0

    def public(self, i: int) -> int:
        return 1 + i

    def new_witness(self) -> int:
        v = self.num_vars
        self.num_vars += 1
        return v

    def constrain(self, a_lc, b_lc, c_lc):
        """(sum a_lc) * (sum b_lc) = (sum c_lc); lcs are [(var, coeff)]."""
        p = self.spec.p
        r = self.n_rows
        for col, v in a_lc:
            self.a.append((r, col, v % p))
        for col, v in b_lc:
            self.b.append((r, col, v % p))
        for col, v in c_lc:
            self.c.append((r, col, v % p))
        self.n_rows += 1

    def mul(self, x: int, y: int) -> int:
        z = self.new_witness()
        self.constrain([(x, 1)], [(y, 1)], [(z, 1)])
        return z

    def add_const(self, x: int, k: int) -> int:
        z = self.new_witness()
        self.constrain([(x, 1), (self.one, k)], [(self.one, 1)], [(z, 1)])
        return z

    def add(self, x: int, y: int) -> int:
        z = self.new_witness()
        self.constrain([(x, 1), (y, 1)], [(self.one, 1)], [(z, 1)])
        return z

    def enforce_equal(self, x: int, y: int):
        self.constrain([(x, 1)], [(self.one, 1)], [(y, 1)])

    def build(self) -> R1CS:
        return R1CS(self.spec, self.num_public, self.num_vars,
                    list(self.a), list(self.b), list(self.c), self.n_rows)
