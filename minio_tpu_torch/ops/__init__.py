"""Kernels and host math: the erasure data plane (rs_gpu.py, hh256_gpu.py)
and the S3 Select predicate scan (select_kernels.py)."""
