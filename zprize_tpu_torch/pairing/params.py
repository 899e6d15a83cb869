"""Pairing parameters for the BLS12 curves of the reference workloads.

Every reference verifier bottoms out in a product-of-pairings check over one
of these two curves (`winderica/plonk/src/proof_system/verifier.rs:229`
multi_pairing for BLS12-381; snarkVM Marlin/KZG over BLS12-377,
`algorithms/src/polycommit/kzg10/mod.rs`).  The tower shape is the standard
one both use (cf. `snarkVM/curves/src/bls12_377/{fq2,fq6,fq12}.rs` and
arkworks `bls12_381/src/curves/g2.rs`):

    Fq2  = Fq [u] / (u^2 - beta)          beta = fq2_nonresidue
    Fq6  = Fq2[v] / (v^3 - xi)            xi   = fq6_nonresidue  (in Fq2)
    Fq12 = Fq6[w] / (w^2 - v)

G2 lives on the sextic twist E'/Fq2: y^2 = x^3 + b', with b' = b/xi
(D-type, BLS12-377) or b' = b*xi (M-type, BLS12-381).  All constants below
are standard public curve parameters (decimal values as documented in the
snarkVM/arkworks sources cited above); the test-suite re-derives and
re-validates each (curve membership, subgroup order, twist equation).
"""

from __future__ import annotations

import dataclasses

from ..curve.spec import BLS12_377_G1, BLS12_381_G1, CurveSpec


@dataclasses.dataclass(frozen=True)
class PairingSpec:
    name: str
    curve: CurveSpec                 # G1 curve (base field Fq, scalar Fr)
    fq2_nonresidue: int              # beta: u^2 = beta in Fq
    fq6_nonresidue: tuple[int, int]  # xi = (c0, c1): v^3 = c0 + c1*u
    x: int                           # BLS parameter (signed)
    twist_type: str                  # "D" (b' = b/xi) or "M" (b' = b*xi)
    g2_b: tuple[int, int]            # twist coefficient b' in Fq2
    g2_gen_x: tuple[int, int]
    g2_gen_y: tuple[int, int]
    g2_cofactor: int

    @property
    def p(self) -> int:
        return self.curve.field.p

    @property
    def r(self) -> int:
        return self.curve.order

    def __hash__(self):
        return hash((self.name, self.x))

    def __eq__(self, other):
        return isinstance(other, PairingSpec) and self.name == other.name


# BLS12-377: x = 0x8508c00000000001 (positive), u^2 = -5, v^3 = u, D twist.
# G2 constants per `snarkVM/curves/src/bls12_377/g2.rs:46-118`.
BLS12_377_PAIRING = PairingSpec(
    name="bls12_377",
    curve=BLS12_377_G1,
    fq2_nonresidue=-5,
    fq6_nonresidue=(0, 1),
    x=0x8508C00000000001,
    twist_type="D",
    g2_b=(0, 155198655607781456406391640216936120121836107652948796323930557600032281009004493664981332883744016074664192874906),
    g2_gen_x=(170590608266080109581922461902299092015242589883741236963254737235977648828052995125541529645051927918098146183295,
              83407003718128594709087171351153471074446327721872642659202721143408712182996929763094113874399921859453255070254),
    g2_gen_y=(1843833842842620867708835993770650838640642469700861403869757682057607397502738488921663703124647238454792872005,
              33145532013610981697337930729788870077912093258611421158732879580766461459275194744385880708057348608045241477209),
    g2_cofactor=7923214915284317143930293550643874566881017850177945424769256759165301436616933228209277966774092486467289478618404761412630691835764674559376407658497,
)

# BLS12-381: x = -0xd201000000010000, u^2 = -1, v^3 = 1+u, M twist (b'=4(1+u)).
# G2 constants per arkworks `bls12_381/src/curves/g2.rs`.
BLS12_381_PAIRING = PairingSpec(
    name="bls12_381",
    curve=BLS12_381_G1,
    fq2_nonresidue=-1,
    fq6_nonresidue=(1, 1),
    x=-0xD201000000010000,
    twist_type="M",
    g2_b=(4, 4),
    g2_gen_x=(352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
              3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758),
    g2_gen_y=(1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
              927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582),
    g2_cofactor=305502333931268344200999753193121504214466019254188142667664032982267604182971884026507427359259977847832272839041616661285803823378372096355777062779109,
)

ALL_PAIRINGS = [BLS12_377_PAIRING, BLS12_381_PAIRING]


def pairing_for_curve(curve: CurveSpec) -> PairingSpec:
    for ps in ALL_PAIRINGS:
        if ps.curve == curve:
            return ps
    raise ValueError(f"no pairing spec for curve {curve.name}")
