"""Measurement scripts of the port: the kernel-1 phase probes (kernel 5), the
int8 matrix-rate probe (kernel 6), the int8 edit's divergence, and the
H100 bounds and CUDA-event timing they share with ``chip_smoke.py``."""
