"""Kernels and host math: the erasure data plane (rs_gpu.py, hh256_gpu.py),
the S3 Select predicate scan (select_kernels.py), the REGEN class's
matrices (rs_regen.py), and the dispatch plane that routes each dispatch
to a lane and a device (batching.py, autotune.py)."""
