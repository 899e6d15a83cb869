"""sw_gather_accumulate: per bucket, the sum of its affine points read
through the sort permutation.  A point is one mixed short-Weierstrass add
(11 mulmods: the RCB formulas for a = 0, products by 3b counted as
additions); it reads the point (2 Fq elements), its permutation index
(8 B) and sign (4 B); each lane (bucket) reads its run's start and count
(16 B) and writes its projective point (3 Fq elements)."""

from . import FQ_BYTES, IMAD_PER_MULMOD

SYMBOLS = ("k_sw_gather_accumulate",)
MULMODS_PER_ROW = 11


def work(rows: int, lanes: int) -> tuple[int, int]:
    return (rows * MULMODS_PER_ROW * IMAD_PER_MULMOD,
            rows * (2 * FQ_BYTES + 8 + 4) + lanes * (16 + 3 * FQ_BYTES))
