"""Peaks of one NVIDIA H100 SXM at its 700 W limit.

HBM3: 3.35 TB/s (NVIDIA's data sheet).  int32: derived, not published:
the data sheet's 67 TFLOP/s of fp32 outside the tensor cores counts an
FMA as two on 128 lanes an SM; int32 has 64 lanes an SM and one op a
lane and clock, a quarter of that figure (132 SMs x 64 lanes x 1.98 GHz
= 16.7e12).  Frozen copy of chip_smoke.py:222-223."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4
