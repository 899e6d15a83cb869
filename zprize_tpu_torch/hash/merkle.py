"""Poseidon Merkle trees with batched 2-to-1 compression: every level
hashes all its sibling pairs in one batched sponge, so a full tree is
log2(n) permutation calls (the Merkle-membership workload of
`winderica/distributed/src/circuit.rs:676-703`).  Nodes are
(..., n_words) Montgomery words of the scalar field."""

from __future__ import annotations

import torch

from ..field import fp
from .grain import PoseidonConfig
from .poseidon import Sponge


def hash_pairs(cfg: PoseidonConfig, left: torch.Tensor, right: torch.Tensor
               ) -> torch.Tensor:
    """Absorb [left, right] into a fresh rate-2 sponge and squeeze one
    element (one permutation), for every pair of the batch."""
    sponge = Sponge(cfg, left.shape[:-1], left.device)
    sponge.absorb([left, right])
    return sponge.squeeze(1)[0]


def build_tree(cfg: PoseidonConfig, leaves: torch.Tensor) -> list:
    """Levels of the full binary tree over (n, n_words) leaves (n a power
    of two), leaves first; levels[-1][0] is the root."""
    n = leaves.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"leaf count must be a power of two, got {n}")
    levels = [leaves]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(hash_pairs(cfg, cur[0::2], cur[1::2]))
    return levels


def root(levels: list) -> torch.Tensor:
    return levels[-1][0]


def prove(levels: list, index: int) -> list:
    """Authentication path of leaf `index`: (sibling, is_right) per level,
    is_right meaning the sibling is the right child."""
    path = []
    for lvl in levels[:-1]:
        path.append((lvl[index ^ 1], index & 1 == 0))
        index >>= 1
    return path


def verify(cfg: PoseidonConfig, spec, root_plane, leaf_plane, index: int,
           path) -> bool:
    cur = leaf_plane
    for sib, sib_is_right in path:
        cur = (hash_pairs(cfg, cur, sib) if sib_is_right
               else hash_pairs(cfg, sib, cur))
    return bool(fp.eq(spec, cur, root_plane).all())
