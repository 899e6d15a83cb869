"""Operations and bytes of each port kernel, one module a kernel, named as
the program's launch counter names it.  Each module gives SYMBOLS, the
kernel's CUDA entry points as the device trace names them, and `work(...)`:
(32-bit integer multiply-adds, bytes) for the rows and lanes one launch
set walks.  Each input byte is counted read once and each output byte
written once."""

# one 12-word CIOS Montgomery multiply (Fq of BLS12-377): 144 wide 32x32
# products for a·b and 144 for m·p, two IMAD slots each, and 12 low-half
# products for m, one each
IMAD_PER_MULMOD = 2 * 288 + 12
FQ_BYTES = 4 * 12
