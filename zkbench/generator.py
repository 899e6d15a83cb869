"""The one generator of the cells' inputs: scalar vectors drawn on the
device from the run's seed, as a traffic file describes them.

A traffic file's "scalars" object says how each scalar is drawn:
  {"kind": "uniform"}          uniform in [0, r), r the BLS12-377 group order
  {"kind": "bits", "bits": k}  uniform in [0, 2^k), k <= 252
Vectors come out as (n, 8) int32 little-endian 32-bit words of the drawn
integers; `compact_limbs` turns them into the (n, 17) base-2^15 limbs the
MSM API takes.  `point_classes` draws which of a configuration's distinct
points each row of a point set holds.  The same seed gives the same
inputs on the same kind of card: one torch.Generator on the device, drawn
in order."""

from __future__ import annotations

import torch

from .reference import curve

WORDS = curve.FR_WORDS
LIMBS = 17
LIMB_BITS = 15
_R_WORDS = [(curve.R >> (32 * j)) & 0xFFFFFFFF for j in range(WORDS)]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    return g


def _words(rows: int, bits: int, gen: torch.Generator, device):
    """rows x WORDS uniform words of `bits` bits (higher words zero)."""
    full, part = divmod(bits, 32)
    w = torch.zeros((rows, WORDS), dtype=torch.int32, device=device)
    top = full + (part > 0)
    w[:, :top] = torch.randint(-(1 << 31), 1 << 31, (rows, top),
                               dtype=torch.int32, generator=gen,
                               device=device)
    if part:
        w[:, full] &= (1 << part) - 1
    return w


def _not_below_r(w: torch.Tensor) -> torch.Tensor:
    """Row indices of w (rows, WORDS) whose integer is >= r."""
    lt = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
    eq = torch.ones_like(lt)
    for j in range(WORDS - 1, -1, -1):
        u = w[:, j].to(torch.int64) & 0xFFFFFFFF
        lt |= eq & (u < _R_WORDS[j])
        eq &= u == _R_WORDS[j]
    return torch.nonzero(~lt)[:, 0]


def draw(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """One vector of n scalars, (n, WORDS) int32."""
    if spec["kind"] == "bits":
        bits = int(spec["bits"])
        if not 1 <= bits < curve.SCALAR_BITS:
            raise ValueError(f"bits must lie in [1, {curve.SCALAR_BITS}), "
                             f"got {bits}")
        return _words(n, bits, gen, device)
    if spec["kind"] != "uniform":
        raise ValueError(f"unknown scalar kind {spec['kind']!r}")
    w = _words(n, curve.SCALAR_BITS, gen, device)
    redo = _not_below_r(w)
    while redo.numel():
        fresh = _words(redo.numel(), curve.SCALAR_BITS, gen, device)
        w[redo] = fresh
        redo = redo[_not_below_r(fresh)]
    return w


def point_classes(n: int, base: int, gen: torch.Generator,
                  device) -> torch.Tensor:
    """n rows' point classes, uniform in [0, base), (n,) int16."""
    if not 1 <= base <= 1 << 15:
        raise ValueError(f"base must lie in [1, 2^15], got {base}")
    return torch.randint(0, base, (n,), dtype=torch.int16, generator=gen,
                         device=device)


def vectors(spec: dict, n: int, count: int, seed: int, device):
    """`count` vectors of n scalars, one after another from one generator."""
    gen = generator(seed, device)
    for _ in range(count):
        yield draw(spec, n, gen, device)


def compact_limbs(words: torch.Tensor) -> torch.Tensor:
    """(n, WORDS) int32 words -> (n, 17) int16 base-2^15 limbs (< 2^15)."""
    out = torch.empty((words.shape[0], LIMBS), dtype=torch.int16,
                      device=words.device)
    for k in range(LIMBS):
        i, sh = divmod(LIMB_BITS * k, 32)
        v = (words[:, i].to(torch.int64) & 0xFFFFFFFF) >> sh
        if sh > 32 - LIMB_BITS and i + 1 < WORDS:
            v |= (words[:, i + 1].to(torch.int64) & 0xFFFFFFFF) << (32 - sh)
        out[:, k] = (v & 0x7FFF).to(torch.int16)
    return out
