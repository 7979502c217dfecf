"""Hand-written GPU kernels, each beside its plain torch version."""
