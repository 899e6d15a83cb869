"""Short-Weierstrass curve specifications for the ZPrize workloads.

BLS12-377 G1 (y^2 = x^3 + 1) and BLS12-381 G1 (y^2 = x^3 + 4), the two MSM
curves of the reference (`open-division/prize1-msm` and `prize4-msm-wasm` /
`prize3-plonk-dizk`).  Parameters are the standard public constants (cf. the
reference's `sppark/ff/bls12-377.hpp:10-31` and arkworks
`ark-bls12-377`/`ark-bls12-381` curve configs); the test-suite revalidates
each of them from scratch (curve membership, Hasse bound, subgroup order),
so nothing here is trusted on faith.
"""

from __future__ import annotations

import dataclasses

from ..field.spec import (BLS12_377_FQ, BLS12_377_FR, BLS12_381_FQ,
                          BLS12_381_FR, FieldSpec)


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    """y^2 = x^3 + b over `field`, prime-order subgroup of size `order`."""

    name: str
    field: FieldSpec         # base field (coordinates)
    scalar: FieldSpec        # scalar field (order of the subgroup)
    b: int
    cofactor: int
    gen_x: int               # affine generator of the order-`order` subgroup
    gen_y: int

    @property
    def b3(self) -> int:
        return 3 * self.b

    @property
    def order(self) -> int:
        return self.scalar.p

    def __hash__(self):
        return hash((self.name, self.b, self.field))

    def __eq__(self, other):
        return isinstance(other, CurveSpec) and (self.name, self.b, self.field) == (
            other.name, other.b, other.field)


BLS12_377_G1 = CurveSpec(
    name="bls12_377_g1",
    field=BLS12_377_FQ,
    scalar=BLS12_377_FR,
    b=1,
    cofactor=0x170B5D44300000000000000000000000,
    gen_x=0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    gen_y=0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
)

# Compile-lean dryrun/test curve (NOT cryptographically strong): j=0 curve
# y^2 = x^3 + 8 over a 62-bit prime, found via Cornacchia (4p = L^2 + 27M^2)
# with a 56-bit prime-order subgroup (cofactor 76).  Same a=0 RCB code paths
# as the BLS curves at ~1/27th the limb-product graph size — used by the
# multi-chip dryrun so the XLA:CPU cold compile of the sharded MSM fits the
# time budget (the full-width curves are covered by tests/test_parallel.py).
# The test-suite revalidates membership and subgroup order from scratch.
TOY_FQ = FieldSpec(name="toy_fq", p=0x3FFFFFFFFFFFFF8B, generator=2)
TOY_FR = FieldSpec(name="toy_fr", p=0xD79435E4798A5B, generator=3)

TOY_G1 = CurveSpec(
    name="toy_g1",
    field=TOY_FQ,
    scalar=TOY_FR,
    b=8,
    cofactor=76,
    gen_x=0x3CE7E31C72F135A9,
    gen_y=0x15DBCC6E20B0E978,
)

BLS12_381_G1 = CurveSpec(
    name="bls12_381_g1",
    field=BLS12_381_FQ,
    scalar=BLS12_381_FR,
    b=4,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
    gen_x=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gen_y=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

ALL_CURVES = [BLS12_377_G1, BLS12_381_G1, TOY_G1]
