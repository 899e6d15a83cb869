"""te_gather_accumulate: per bucket, the sum of its rows of the point table
read through the sort permutation.  A row is one mixed twisted-Edwards
add (7 mulmods); it reads the row's three operands (3 Fq elements), its
permutation index (8 B) and sign (4 B); each lane (bucket) reads its run's
start and count (16 B) and writes its extended point (4 Fq elements)."""

from . import FQ_BYTES, IMAD_PER_MULMOD

SYMBOLS = ("k_gather_accumulate",)
MULMODS_PER_ROW = 7


def work(rows: int, lanes: int) -> tuple[int, int]:
    return (rows * MULMODS_PER_ROW * IMAD_PER_MULMOD,
            rows * (3 * FQ_BYTES + 8 + 4) + lanes * (16 + 4 * FQ_BYTES))
