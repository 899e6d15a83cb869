"""Four-step NTT over a world of ranks.

The 2^24 four-step decomposition of the prize2 entries
(`zprize_ntt_top.mld:53-75`) with the transpose between the two passes
done by an all_to_all between the ranks instead of a relayout in one
device's memory: the matrix is column-sharded for the column pass (local
column NTTs and the step twiddle of the rank's own columns) and
row-sharded for the row pass.

Layout, as the reference's (`zprize_tpu/parallel/ntt_sharded.py`):
  input  M[j1, j2] = a[j1 n2 + j2], columns sharded: rank r holds the
         (n1, n2/D, L) block of columns [r n2/D, (r+1) n2/D);
  output C[k1, k2] with A[k1 + n1 k2] = C[k1, k2], rows sharded: rank r
         holds the (n1/D, n2, L) block of rows [r n1/D, (r+1) n1/D).
`flatten_output` gathers the natural-order vector (tests and checks).

Elements are Montgomery word planes (..., L) of `field/fp.py`.  For the
scalar fields every sub-transform goes through `radix2.ntt` (`fr_ntt`).
For Goldilocks the words become canonical u64 values (`ntt/gl_ops`) once
on the way in and once on the way out: each pass is one `ntt_packed`
call (the `gl_ntt` kernel) over the rank's columns or rows, and the step
twiddle a `gl_ops.gl_mul` between them.
"""

from __future__ import annotations

import torch

from ..field import fp
from ..field.spec import GOLDILOCKS, FieldSpec
from ..ntt import gl_kernel, gl_ops
from ..ntt.domain import Domain, primitive_root
from ..ntt.radix2 import ntt
from ..poly import ops as poly_ops
from .mesh import World, all_gather_rows, all_to_all_tiled

_tw_cache: dict = {}


def column_twiddles(spec: FieldSpec, log_n1: int, log_n2: int, j0: int,
                    cols: int, inverse: bool, device) -> torch.Tensor:
    """Columns [j0, j0 + cols) of the step twiddle W[k1, j2] = w^(±k1 j2),
    w the primitive 2^(log_n1 + log_n2)-th root, as (n1, cols, L) words on
    `device`: the power ladder of each column's w^j2 (so a rank builds
    only its own columns, with no table of the whole domain).  The same
    values as `ntt.fourstep.twiddle_matrix`'s columns."""
    dev = torch.device(device)
    key = (spec.name, log_n1, log_n2, j0, cols, inverse, dev)
    if key not in _tw_cache:
        p = spec.p
        w = primitive_root(spec, log_n1 + log_n2)
        if inverse:
            w = pow(w, -1, p)
        base = fp.from_ints(spec, [pow(w, j, p)
                                   for j in range(j0, j0 + cols)], dev)
        _tw_cache[key] = poly_ops.powers(
            spec, base, 1 << log_n1).transpose(0, 1).contiguous()
    return _tw_cache[key]


def _goldilocks_twiddles(log_n1, log_n2, j0, cols, device) -> torch.Tensor:
    """`column_twiddles` of Goldilocks as canonical values (n1, cols)."""
    key = ("canonical", log_n1, log_n2, j0, cols, torch.device(device))
    if key not in _tw_cache:
        _tw_cache[key] = gl_ops.from_words(column_twiddles(
            GOLDILOCKS, log_n1, log_n2, j0, cols, False, device))
    return _tw_cache[key]


def ntt_fourstep_sharded(spec: FieldSpec, m_local: torch.Tensor,
                         world: World, log_n1: int, log_n2: int
                         ) -> torch.Tensor:
    """m_local: this rank's (n1, n2/D, L) column block of M on its device.
    Returns its (n1/D, n2, L) row block of C."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    d = world.size
    if n1 % d or n2 % d:
        raise ValueError(f"{n1} x {n2} does not split over {d} ranks")
    cols = n2 // d
    if tuple(m_local.shape[:2]) != (n1, cols):
        raise ValueError(f"m_local: expected ({n1}, {cols}, L), got "
                         f"{tuple(m_local.shape)}")
    dev, j0 = m_local.device, world.rank * cols
    if spec.name == GOLDILOCKS.name:
        x = gl_kernel.ntt_packed(log_n1, gl_ops.from_words(m_local),
                                 device=dev)                 # column NTTs
        x = gl_ops.gl_mul(x, _goldilocks_twiddles(log_n1, log_n2, j0, cols,
                                                  dev))
        x = all_to_all_tiled(x, 0, 1, world)   # columns -> rows sharded
        x = gl_kernel.ntt_packed(log_n2, x.t(), device=dev)  # row NTTs
        return gl_ops.to_words(x.t())
    m = ntt(Domain(spec, log_n1, dev), m_local, axis=0)      # column NTTs
    m = fp.mul(spec, m, column_twiddles(spec, log_n1, log_n2, j0, cols,
                                        False, dev))
    m = all_to_all_tiled(m, 0, 1, world)       # columns -> rows sharded
    return ntt(Domain(spec, log_n2, dev), m, axis=1)         # row NTTs


def flatten_output(c_local: torch.Tensor, world: World) -> torch.Tensor:
    """The row blocks of C gathered into natural order A[k1 + n1 k2] (n, L),
    on every rank."""
    c = all_gather_rows(c_local, world)                        # (n1, n2, L)
    return c.transpose(0, 1).reshape(-1, c.shape[-1])
