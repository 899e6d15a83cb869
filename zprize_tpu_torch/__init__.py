"""PyTorch + hand-written CUDA port of zprize_tpu for one NVIDIA H100.

Layout mirrors the reference package (field/, curve/, msm/); csrc/ holds
the CUDA sources, built at first use by utils/build.py.  Ported so far:
the collapsed twisted-Edwards BLS12-377 MSM (msm/api.py).
"""
