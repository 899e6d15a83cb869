"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W power
limit), against which a kernel's roofline share is stated."""

# HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
# 67 TFLOP/s of float32 outside the tensor cores is 33.5 T FMA/s.  ASSUMED:
# Hopper issues 32-bit integer multiply-adds (IMAD) at half the FMA rate.
IMAD_PER_S = 16.75e12


def least_seconds(imad: float, n_bytes: float) -> float:
    """The least time the card could take for `imad` integer multiply-adds
    and `n_bytes` of memory traffic: the larger of the two bounds."""
    return max(imad / IMAD_PER_S, n_bytes / HBM_BYTES_PER_S)
