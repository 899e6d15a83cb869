"""The plain reference: BLS12-377 G1 arithmetic on Python ints and the
expected results of the cells' calls.  It imports nothing of the program
and reads nothing the program made; it reads the program's outputs only to
judge them."""
