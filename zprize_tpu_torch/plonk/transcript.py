"""Poseidon Fiat-Shamir transcript (the role of jf-plonk's
`plonk/src/transcript.rs` and snarkVM's `fiat_shamir_algebraic_sponge.rs`).

It runs on the host over python ints (`Sponge(host=True)`): it absorbs a
few dozen single elements per proof, and its challenges are the same
field elements as the reference transcript's.

Encoding, as the reference's: an Fq coordinate (377 bits) enters the Fr
sponge as two elements, the canonical value's low 13 and high 13
base-2^15 limbs, lo = x mod 2^195 and hi = x >> 195.  The identity point
embeds as (0, 0).

`Transcript.broadcast(B)` forks B lanes (`TranscriptLanes`), each an
independent host sponge: lane b's challenges are those of a single
transcript fed lane b's absorbs, as the reference's broadcast (B-lane)
transcript gives them.
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

    def broadcast(self, batch: int) -> "TranscriptLanes":
        """Fork into `batch` lanes that evolve independently from this
        state (the B-instance prover and verifier: one lane a proof)."""
        return TranscriptLanes([self.clone() for _ in range(batch)])


class TranscriptLanes:
    """B transcripts driven together: every absorb takes a list of one
    value a lane, and `challenge` returns one int a lane."""

    def __init__(self, lanes: list[Transcript]):
        self.lanes = lanes

    def absorb_fr(self, values):
        if len(values) != len(self.lanes):
            raise ValueError(f"{len(values)} values for {len(self.lanes)} "
                             "lanes")
        for tr, v in zip(self.lanes, values):
            tr.absorb_fr(v)

    def absorb_points_ints(self, xys):
        """Absorb one host affine point (x, y), or None, a lane."""
        if len(xys) != len(self.lanes):
            raise ValueError(f"{len(xys)} points for {len(self.lanes)} "
                             "lanes")
        for tr, xy in zip(self.lanes, xys):
            tr.absorb_point_ints(xy)

    def challenge(self) -> list[int]:
        return [tr.challenge() for tr in self.lanes]


def lane_points_ints(curve: CurveSpec, p: sw.Point) -> list:
    """A (B,)-lane projective point -> B host affine int pairs (None for
    an identity lane), with one copy from the device."""
    q = curve.field.p
    xyz = fp.to_ints(curve.field, torch.stack(tuple(p)))
    out = []
    for x, y, z in zip(*xyz):
        if z == 0:
            out.append(None)
            continue
        zinv = pow(int(z), -1, q)
        out.append((int(x) * zinv % q, int(y) * zinv % q))
    return out


def vk_transcript(curve: CurveSpec, vk, label: int = LABEL,
                  absorb=None) -> Transcript:
    """A transcript forked from the verifying key's absorbed prefix, which
    is the same for every proof under one key and so is built once per key
    (cached on `vk`).  `absorb(transcript, vk)` replaces
    `Transcript.absorb_vk` for keys of another protocol (Marlin's)."""
    cached = getattr(vk, "_transcript_prefix", None)
    if cached is None or cached[0] != label:
        tr = Transcript(curve, label=label)
        (absorb or Transcript.absorb_vk)(tr, vk)
        cached = (label, tr)
        vk._transcript_prefix = cached
    return cached[1].clone()
