"""Poseidon permutation and duplex sponge with snarkVM semantics
(`snarkVM algorithms/src/crypto_hash/poseidon.rs:27-183`), validated
against its snapshot fixtures.

Two forms of one permutation (ark -> S-box -> MDS; partial rounds S-box
lane 0 only; the S-box x^17 is 4 squarings and 1 multiplication):

* `permute` over a batch of states (..., t, n_words) of Montgomery words
  on the plain engine ``field/fp.py``, on the states' device: the Merkle
  trees hash every pair of a level at once;
* `permute_ints` over one state of python ints: a Fiat-Shamir transcript
  absorbs one element at a time, where the host's big-int arithmetic
  (about 600 modular multiplications, under a millisecond) beats thousands
  of plain-engine launches on the card.

`Sponge` runs the same duplex bookkeeping over either form (`host=True`
for python ints).
"""

from __future__ import annotations

import functools

import torch

from ..field import fp
from ..utils.device import resolve_device
from .grain import PoseidonConfig


@functools.lru_cache(maxsize=None)
def _tables(cfg: PoseidonConfig, device: torch.device):
    """ark (rounds, t, nw) and mds (t, t, nw) as Montgomery words."""
    f = cfg.spec
    return (fp.from_ints(f, [list(r) for r in cfg.ark], device),
            fp.from_ints(f, [list(r) for r in cfg.mds], device))


def _sbox(cfg: PoseidonConfig, x: torch.Tensor) -> torch.Tensor:
    """x^alpha by binary square-and-multiply (alpha is 17 or 5)."""
    f = cfg.spec
    result, base, e = None, x, cfg.alpha
    while e:
        if e & 1:
            result = base if result is None else fp.mul(f, result, base)
        e >>= 1
        if e:
            base = fp.sqr(f, base)
    return result


def _is_full(cfg: PoseidonConfig, r: int) -> bool:
    half = cfg.full_rounds // 2
    return r < half or r >= half + cfg.partial_rounds


def permute(cfg: PoseidonConfig, state: torch.Tensor) -> torch.Tensor:
    """One Poseidon permutation of every state (..., t, n_words)."""
    f = cfg.spec
    ark, mds = _tables(cfg, state.device)
    for r in range(cfg.full_rounds + cfg.partial_rounds):
        state = fp.add(f, state, ark[r])
        if _is_full(cfg, r):
            state = _sbox(cfg, state)
        else:
            state = torch.cat([_sbox(cfg, state[..., :1, :]),
                               state[..., 1:, :]], dim=-2)
        terms = fp.mul(f, state[..., None, :, :], mds)   # (..., t, t, nw)
        state = terms[..., 0, :]
        for j in range(1, cfg.t):
            state = fp.add(f, state, terms[..., j, :])
    return state


def permute_ints(cfg: PoseidonConfig, state: list[int]) -> list[int]:
    """The same permutation of one state of python ints."""
    p = cfg.spec.p
    for r in range(cfg.full_rounds + cfg.partial_rounds):
        state = [(s + a) % p for s, a in zip(state, cfg.ark[r])]
        if _is_full(cfg, r):
            state = [pow(s, cfg.alpha, p) for s in state]
        else:
            state[0] = pow(state[0], cfg.alpha, p)
        state = [sum(m * s for m, s in zip(row, state)) % p
                 for row in cfg.mds]
    return state


class Sponge:
    """Duplex Poseidon sponge with snarkVM semantics (`poseidon.rs:123-330`):
    capacity element first, absorb/squeeze mode tracking, a permutation
    when the rate runs out.

    The state is a (*batch_shape, t, n_words) tensor on `device` (the card
    unless the caller asks for the CPU), whose absorbed and squeezed
    elements are (*batch_shape, n_words) planes, or, with `host=True`, a
    list of t python ints, whose elements are ints."""

    def __init__(self, cfg: PoseidonConfig, batch_shape=(), device=None,
                 host: bool = False):
        self.cfg = cfg
        self.host = host
        self.state = ([0] * cfg.t if host else
                      fp.zeros(cfg.spec, (*batch_shape, cfg.t),
                               resolve_device(device)))
        self.mode = ("absorbing", 0)

    def clone(self) -> "Sponge":
        """Snapshot of the duplex state: a cached absorbed prefix (a
        verifying key) forks per proof."""
        s = object.__new__(Sponge)
        s.cfg, s.host, s.mode = self.cfg, self.host, self.mode
        s.state = list(self.state) if self.host else self.state
        return s

    def _permute(self):
        self.state = (permute_ints(self.cfg, self.state) if self.host
                      else permute(self.cfg, self.state))

    def _add_rate_elem(self, idx: int, value):
        j = self.cfg.capacity + idx
        if self.host:
            self.state[j] = (self.state[j] + value) % self.cfg.spec.p
            return
        st = self.state.clone()
        st[..., j, :] = fp.add(self.cfg.spec, st[..., j, :], value)
        self.state = st

    def absorb(self, elements):
        if not elements:
            return
        mode, idx = self.mode
        if mode == "squeezing" or idx == self.cfg.rate:
            self._permute()
            idx = 0
        for e in elements:
            if idx == self.cfg.rate:
                self._permute()
                idx = 0
            self._add_rate_elem(idx, e)
            idx += 1
        self.mode = ("absorbing", idx)

    def squeeze(self, count: int) -> list:
        if count == 0:
            return []
        mode, idx = self.mode
        if mode == "absorbing" or idx == self.cfg.rate:
            self._permute()
            idx = 0
        out = []
        for _ in range(count):
            if idx == self.cfg.rate:
                self._permute()
                idx = 0
            j = self.cfg.capacity + idx
            out.append(self.state[j] if self.host else self.state[..., j, :])
            idx += 1
        self.mode = ("squeezing", idx)
        return out


def hash_many(cfg: PoseidonConfig, inputs, num_outputs: int = 1) -> list:
    """Poseidon::evaluate_many: absorb all inputs (a list of
    (..., n_words) planes), squeeze `num_outputs` planes."""
    sponge = Sponge(cfg, inputs[0].shape[:-1], inputs[0].device)
    sponge.absorb(inputs)
    return sponge.squeeze(num_outputs)
