"""PyTorch + hand-written CUDA port of zprize_tpu for one NVIDIA H100.

Layout mirrors the reference package (field/, curve/, msm/, ntt/, poly/,
pcs/, hash/, pairing/, plonk/, marlin/, posw/); csrc/ holds the CUDA
sources and the host C++ linear combination, built at first use by
utils/build.py.  Not ported yet: the sharded forms (parallel/).
"""
