"""pulse_chase on Hopper: build, bind and launch the CUDA kernel.

The kernel (``src/repro_torch/csrc/pulse_chase.cu``) replaces the TPU
kernel ``src/repro/kernels/pulse_chase/kernel.py::_chase_kernel``.  It
interprets the iterator's PULSE ISA program per lane instead of taking a
traced closure.  What bounds it on the card: dependent gathers, one per
lane-step, so it is latency-bound; its least time is the bytes bound
(``W*4`` bytes per executed lane-step plus the lane state in and out once,
over 3.35 TB/s).  What the design does about it: one thread per lane and
many resident lanes per SM, so the warp scheduler overlaps the gathers of
independent lanes.

The source is built and loaded by ``kernels._build`` (``nvcc`` for
``sm_90a``, a hashed library under ``build/kernels/``, ``ctypes``).  The
opcode numbering is passed to the compiler from ``core.isa`` as
``-DPULSE_OP_<NAME>`` defines, so the kernel has no copy of its own.  A
build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import isa
from repro_torch.core.arena import MAX_NODE_WORDS
from repro_torch.kernels import _build

OPCODE_DEFINES = tuple(
    f"-DPULSE_OP_{name}={op}" for op, name in sorted(isa.OP_NAMES.items())
) + (f"-DPULSE_LAST_OP={max(isa.ALL_OPS)}",)
SOURCE = _build.KernelSource("pulse_chase", _build.CSRC / "pulse_chase.cu", OPCODE_DEFINES)
_SRC = SOURCE.source
NVCC_FLAGS = SOURCE.flags

MAX_SCRATCH_WORDS = 32
MAX_PROGRAM_ROWS = 1024  # 16 KB of shared memory


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = SOURCE.load()
    fn = lib.pulse_chase_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # arena, cap, W
        ctypes.c_void_p, ctypes.c_int,  # code, T
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # in
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, num_steps
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    lib.pulse_chase_error_string.argtypes = [ctypes.c_int]
    lib.pulse_chase_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"pulse_chase: {name} is on {t.device}, the arena on {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"pulse_chase: {name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"pulse_chase: {name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"pulse_chase: {name} must be contiguous")


def launch(arena, ptr, scratch, status, iters, code, num_steps: int):
    """Launch the kernel once on PyTorch's current stream; returns new
    ``(ptr, scratch, status, iters)``.  Does not synchronise."""
    dev = arena.device
    if dev.type != "cuda":
        raise ValueError(f"pulse_chase kernel needs CUDA tensors, got {dev}")
    for name, t, nd in (("arena", arena, 2), ("ptr", ptr, 1), ("scratch", scratch, 2),
                        ("status", status, 1), ("iters", iters, 1), ("code", code, 2)):
        _check(name, t, dev, nd)
    cap, W = arena.shape
    B, S = scratch.shape
    T = code.shape[0]
    if W > MAX_NODE_WORDS:
        raise ValueError(f"pulse_chase: node_words {W} > {MAX_NODE_WORDS}")
    if S > MAX_SCRATCH_WORDS:
        raise ValueError(f"pulse_chase: scratch_words {S} > {MAX_SCRATCH_WORDS}")
    if not 0 < T <= MAX_PROGRAM_ROWS or code.shape[1] != 4:
        raise ValueError(
            f"pulse_chase: program must be (T, 4) with 0 < T <= {MAX_PROGRAM_ROWS}, "
            f"got {tuple(code.shape)}"
        )
    if cap == 0:
        raise ValueError("pulse_chase: empty arena")
    if not ptr.shape[0] == status.shape[0] == iters.shape[0] == B:
        raise ValueError("pulse_chase: lane tensors disagree on the batch size")
    outs = (torch.empty_like(ptr), torch.empty_like(scratch),
            torch.empty_like(status), torch.empty_like(iters))
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.pulse_chase_launch(
            arena.data_ptr(), cap, W, code.data_ptr(), T,
            ptr.data_ptr(), scratch.data_ptr(), status.data_ptr(), iters.data_ptr(),
            *(o.data_ptr() for o in outs),
            B, S, int(num_steps), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"pulse_chase launch failed: CUDA error {err} "
            f"({lib.pulse_chase_error_string(err).decode()})"
        )
    return outs
