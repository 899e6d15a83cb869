"""PLONK arithmetization: gates, copy constraints, permutation encoding.

Standard-PLONK constraint system (Gabizon–Williamson–Ciobotaru), the same
gate shape the reference's jf-plonk fork arithmetizes
(`prize3-plonk-dizk/winderica/plonk/src/circuit/`):
    q_L*a + q_R*b + q_O*c + q_M*a*b + q_C + PI = 0    on the domain H,
with copy constraints enforced by the 3-column permutation argument
(sigma polynomials over cosets 1*H, k1*H, k2*H).

Host-side circuit building (python ints), device proving.  The builder is
deliberately simple; the *merge/partial-circuit* machinery of the reference
(`winderica/distributed/src/circuit.rs:356-384`) maps onto concatenating
gate lists and offsetting variable ids, which this representation supports
trivially.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..field.spec import FieldSpec


@dataclasses.dataclass
class Gate:
    ql: int
    qr: int
    qo: int
    qm: int
    qc: int
    a: int  # variable ids
    b: int
    c: int


class CircuitBuilder:
    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.n_vars = 0
        self.gates: list[Gate] = []
        self.public_rows: list[int] = []  # gate rows exposing a public input

    def new_var(self) -> int:
        self.n_vars += 1
        return self.n_vars - 1

    def zero_var(self) -> int:
        """A variable constrained to zero (q_L * a = 0)."""
        v = self.new_var()
        self.gates.append(Gate(1, 0, 0, 0, 0, v, v, v))
        return v

    def add_gate(self, ql, qr, qo, qm, qc, a, b, c):
        p = self.spec.p
        self.gates.append(Gate(ql % p, qr % p, qo % p, qm % p, qc % p, a, b, c))

    def public_input(self, v: int):
        """Expose variable v as a public input: row with q_L=1 and PI=-value.
        (PI values supplied at prove/verify time, in declaration order.)"""
        row = len(self.gates)
        self.gates.append(Gate(1, 0, 0, 0, 0, v, v, v))
        self.public_rows.append(row)

    # convenience gates -----------------------------------------------------
    def add(self, a: int, b: int) -> int:
        c = self.new_var()
        self.add_gate(1, 1, -1, 0, 0, a, b, c)
        return c

    def mul(self, a: int, b: int) -> int:
        c = self.new_var()
        self.add_gate(0, 0, -1, 1, 0, a, b, c)
        return c

    def add_const(self, a: int, k: int) -> int:
        c = self.new_var()
        self.add_gate(1, 0, -1, 0, k, a, a, c)
        return c

    def assert_equal_const(self, a: int, k: int):
        self.add_gate(1, 0, 0, 0, -k, a, a, a)

    def merge(self, other: "CircuitBuilder") -> int:
        """Append another builder's gates with variable/row ids offset — the
        partial-circuit merge of the reference
        (`winderica/distributed/src/circuit.rs:356-384`
        `PlonkCircuit::{new_partial, merge}`).  Returns the variable-id
        offset applied to `other`'s ids."""
        assert other.spec is self.spec
        var_off = self.n_vars
        row_off = len(self.gates)
        for g in other.gates:
            self.gates.append(Gate(g.ql, g.qr, g.qo, g.qm, g.qc,
                                   g.a + var_off, g.b + var_off,
                                   g.c + var_off))
        self.public_rows.extend(r + row_off for r in other.public_rows)
        self.n_vars += other.n_vars
        return var_off

    def compute_witness(self, assignment: dict[int, int]) -> dict[int, int]:
        """Forward witness propagation: walk gates in order and solve each
        output-carrying gate (q_O != 0) for its c variable.  Gadget-built
        circuits are in topological order by construction, so one pass
        completes the assignment (the host-side analog of the reference's
        per-proof witness computation inside `generate_circuit`)."""
        p = self.spec.p
        out = dict(assignment)
        for g in self.gates:
            if g.qo == 0 or g.c in out:
                continue
            a = out.get(g.a, 0)
            b = out.get(g.b, 0)
            val = (g.ql * a + g.qr * b + g.qm * a * b + g.qc) % p
            out[g.c] = val * pow((-g.qo) % p, p - 2, p) % p
        return out

    def compile(self) -> "CompiledCircuit":
        # floor of 8: the blinded quotient has degree 3n+5, which the
        # prover's 4n evaluation coset can only carry when 3n+5 < 4n (n >= 8)
        n = max(8, 1 << (len(self.gates) - 1).bit_length())
        return CompiledCircuit(self, n)


def _coset_constants(spec: FieldSpec, n: int) -> tuple[int, int]:
    """k1, k2 with 1*H, k1*H, k2*H pairwise disjoint (checked: k^n != 1 and
    (k2/k1)^n != 1)."""
    p = spec.p
    k = 2
    found = []
    while len(found) < 2:
        ok = pow(k, n, p) != 1
        if ok and found:
            ratio = found[0] * pow(k, p - 2, p) % p
            ok = pow(ratio, n, p) != 1
        if ok:
            found.append(k)
        k += 1
    return found[0], found[1]


class CompiledCircuit:
    """Padded, permutation-encoded circuit of domain size n (power of two).

    Arrays (numpy, host): selectors q_* (n,), sigma (3, n) as *position
    indices* into the 3n wire slots; the prover/preprocessor turns them into
    field-element polynomials."""

    def __init__(self, builder: CircuitBuilder, n: int):
        assert len(builder.gates) <= n
        self.spec = builder.spec
        self.n = n
        self.n_vars = builder.n_vars
        self.public_rows = list(builder.public_rows)
        self.k1, self.k2 = _coset_constants(builder.spec, n)

        p = builder.spec.p
        g = builder.gates
        self.ql = np.array([x.ql for x in g] + [0] * (n - len(g)), object)
        self.qr = np.array([x.qr for x in g] + [0] * (n - len(g)), object)
        self.qo = np.array([x.qo for x in g] + [0] * (n - len(g)), object)
        self.qm = np.array([x.qm for x in g] + [0] * (n - len(g)), object)
        self.qc = np.array([x.qc for x in g] + [0] * (n - len(g)), object)

        # wire slots: column 0 rows [0,n), column 1 rows [n,2n), column 2 [2n,3n)
        # padding rows reference a fresh dummy variable per slot (no copies).
        self.wires = np.zeros((3, n), dtype=np.int64)
        dummy = builder.n_vars
        for j in range(n):
            if j < len(g):
                self.wires[0, j] = g[j].a
                self.wires[1, j] = g[j].b
                self.wires[2, j] = g[j].c
            else:
                self.wires[0, j] = dummy
                self.wires[1, j] = dummy
                self.wires[2, j] = dummy
        self.n_vars_padded = dummy + 1

        # sigma: for each variable, its slot cycle; sigma maps each slot to
        # the next slot holding the same variable (a cyclic shift per cycle).
        slots_of_var: dict[int, list[int]] = {}
        for col in range(3):
            for j in range(n):
                slots_of_var.setdefault(int(self.wires[col, j]), []).append(col * n + j)
        sigma = np.arange(3 * n, dtype=np.int64)
        for slots in slots_of_var.values():
            for i, s in enumerate(slots):
                sigma[s] = slots[(i + 1) % len(slots)]
        self.sigma = sigma.reshape(3, n)  # slot index = col * n + j

    def wire_values(self, assignment: dict[int, int]) -> np.ndarray:
        """(3, n) object array of wire values for a full variable assignment."""
        out = np.zeros((3, self.n), dtype=object)
        for col in range(3):
            for j in range(self.n):
                out[col, j] = assignment.get(int(self.wires[col, j]), 0) % self.spec.p
        return out

    def check_assignment(self, assignment: dict[int, int], public: list[int]):
        """Host-side sanity: every gate satisfied (debug aid)."""
        p = self.spec.p
        w = self.wire_values(assignment)
        pi = np.zeros((self.n,), dtype=object)
        for idx, row in enumerate(self.public_rows):
            pi[row] = (-public[idx]) % p
        for j in range(self.n):
            val = (self.ql[j] * w[0, j] + self.qr[j] * w[1, j]
                   + self.qo[j] * w[2, j] + self.qm[j] * w[0, j] * w[1, j]
                   + self.qc[j] + pi[j]) % p
            assert val == 0, f"gate {j} unsatisfied"
