"""PULSE (arXiv:2305.02388) in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper: the counterpart of the ``repro`` package, module for module.

Entry points that create state place it on the card (``device="cuda"``)
unless the caller asks for the CPU; everything downstream follows the
arena's device.
"""
