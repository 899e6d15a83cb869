"""The benchmark of zprize_tpu_torch on NVIDIA GPUs.

One command runs one cell once:

    python3 -m zkbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell lives in files found by name: the cells and metrics
in ``BENCHMARK.json`` at the root of the checkout, each configuration in
``configs/<config>.json``, each traffic mix in ``traffic/<mix>.json``, the
call a window drives in ``entries/<entry>.py``, a per-layer metric's
reader in ``metrics/<metric>.py`` (or, for a quantity split by the
end-to-end metric it moves, the shared reader in ``readers.py`` that its
name picks) and each kernel's operation and byte counts in
``counts/<kernel>.py``.  ``reference/`` holds the plain reference that
decides ``correct``: Python ints, NumPy and plain PyTorch, importing
nothing of the program.
"""
