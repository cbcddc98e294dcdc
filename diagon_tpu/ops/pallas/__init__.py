"""Pallas kernels for the GPU (Triton route), each beside its plain-XLA
reference in ``diagon_tpu/ops``."""
