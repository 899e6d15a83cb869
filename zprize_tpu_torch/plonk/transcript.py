"""Poseidon Fiat-Shamir transcript (the role of jf-plonk's
`plonk/src/transcript.rs` and snarkVM's `fiat_shamir_algebraic_sponge.rs`).

It runs on the host over python ints (`Sponge(host=True)`): it absorbs a
few dozen single elements per proof, and its challenges are the same
field elements as the reference transcript's.

Encoding, as the reference's: an Fq coordinate (377 bits) enters the Fr
sponge as two elements, the canonical value's low 13 and high 13
base-2^15 limbs, lo = x mod 2^195 and hi = x >> 195.  The identity point
embeds as (0, 0).
"""

from __future__ import annotations

import torch

from ..curve import sw
from ..curve.spec import CurveSpec
from ..field import fp
from ..field.spec import BASE_BITS
from ..hash import poseidon
from ..hash.grain import snarkvm_config

LABEL = 0x504C4F4E4B  # "PLONK"


class Transcript:
    def __init__(self, curve: CurveSpec, label: int = LABEL):
        self.curve = curve
        self.fr = curve.scalar
        self.sponge = poseidon.Sponge(snarkvm_config(self.fr, 2), host=True)
        self.sponge.absorb([label % self.fr.p])

    def _embed_fq(self, x: int) -> list[int]:
        bits = BASE_BITS * (self.curve.field.n_limbs // 2)
        return [x & ((1 << bits) - 1), x >> bits]

    def absorb_point_ints(self, xy):
        """Absorb an affine point given as a host (x, y) int pair (None =
        identity)."""
        x, y = (0, 0) if xy is None else xy
        self.sponge.absorb(self._embed_fq(x % self.curve.field.p)
                           + self._embed_fq(y % self.curve.field.p))

    def absorb_point(self, p: sw.Point):
        self.absorb_point_ints(sw.to_affine_ints(self.curve, p))

    def absorb_fr(self, x):
        """Absorb a scalar-field element: a python int or a word row."""
        if isinstance(x, torch.Tensor):
            x = int(fp.to_ints(self.fr, x)[()])
        self.sponge.absorb([x % self.fr.p])

    def absorb_vk(self, vk):
        """Bind the verifying key (domain size, coset shifts, public rows,
        selector and sigma commitments), so that challenges differ across
        circuits and a proof cannot move to another key."""
        ints = [vk.n, vk.k1, vk.k2, len(vk.public_rows), *vk.public_rows]
        self.sponge.absorb([v % self.fr.p for v in ints])
        for name in sorted(vk.commitments):
            self.absorb_point(vk.commitments[name])

    def challenge(self) -> int:
        """One Fr challenge (a squeezed sponge element), as an int."""
        return self.sponge.squeeze(1)[0]

    def clone(self) -> "Transcript":
        t = object.__new__(Transcript)
        t.curve, t.fr = self.curve, self.fr
        t.sponge = self.sponge.clone()
        return t


def vk_transcript(curve: CurveSpec, vk, label: int = LABEL) -> Transcript:
    """A transcript forked from the verifying key's absorbed prefix, which
    is the same for every proof under one key and so is built once per key
    (cached on `vk`)."""
    cached = getattr(vk, "_transcript_prefix", None)
    if cached is None or cached[0] != label:
        tr = Transcript(curve, label=label)
        tr.absorb_vk(vk)
        cached = (label, tr)
        vk._transcript_prefix = cached
    return cached[1].clone()
