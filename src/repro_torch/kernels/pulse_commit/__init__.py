"""pulse_commit: the write path's commit phase as a CUDA kernel (``ops``),
its plain version (``ref``) and its build and binding (``kernel``)."""
