"""pulse_commit on Hopper: the bindings of the three CUDA kernels and the
launch sequence around one ``torch.sort``.

The source (``src/repro_torch/csrc/pulse_commit.cu``) replaces the JAX
package's ``_commit_phase`` (``src/repro/core/routing.py:407``), XLA with no
Pallas kernel.  A commit phase is four steps on the current stream:
``commit_key`` (every record's order key), ``torch.sort`` of each shard's
keys, ``commit_apply`` (the STOREs and CASes, one group of lanes per
same-slot run, every run at once) and ``commit_tail`` (per shard the FREEs
in parallel, the ALLOCs popped serially from the free list and then claimed
from the bump pointer in parallel, the heap registers).  Nothing is read on
the host.  The record layout, opcodes and heap registers reach the source
as ``-D`` defines from the port's modules.  Built and loaded by
``kernels._build``; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import arena as _arena
from repro_torch.core import iterator as _iterator
from repro_torch.core import routing
from repro_torch.kernels import _build
from repro_torch.kernels.pulse_commit import ref as _ref

MAX_WORDS = 64  # a node row is at most 256 B

LAYOUT_DEFINES = dict(
    PC_F_ID=routing.F_ID, PC_F_HOME=routing.F_HOME, PC_F_STATUS=routing.F_STATUS,
    PC_F_SCRATCH=routing.F_SCRATCH, PC_STATUS_EMPTY=_iterator.STATUS_EMPTY,
    PC_M_NONE=_arena.M_NONE, PC_M_STORE=_arena.M_STORE, PC_M_CAS=_arena.M_CAS,
    PC_M_ALLOC=_arena.M_ALLOC, PC_M_FREE=_arena.M_FREE, PC_H_FREE=_arena.H_FREE,
    PC_H_BUMP=_arena.H_BUMP, PC_H_EPOCH=_arena.H_EPOCH, PC_H_COMMITS=_arena.H_COMMITS,
    PC_HEAP_WORDS=_arena.HEAP_WORDS, PC_STATUS_FAULT=_iterator.STATUS_FAULT,
    PC_NULL=_arena.NULL, PC_PERM_WRITE=_arena.PERM_WRITE, PC_MAX_WORDS=MAX_WORDS,
)
SOURCE = _build.KernelSource(
    "pulse_commit", _build.CSRC / "pulse_commit.cu",
    tuple(f"-D{k}={v}" for k, v in LAYOUT_DEFINES.items()),
)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = SOURCE.load()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        # pools, bounds, key; P, L, R, S, cap, shard0, row0; stream
        "pulse_commit_key_launch": [ptr] * 3 + [i32] * 7 + [ptr],
        # pools, data, sorted keys, order, perms; P, L, R, S, W, cap, shard0; stream
        "pulse_commit_apply_launch": [ptr] * 5 + [i32] * 7 + [ptr],
        # pools, data, heap, sorted keys, order, bounds, perms; P, L, R, S, W, cap, shard0,
        # row0; stream
        "pulse_commit_tail_launch": [ptr] * 7 + [i32] * 8 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pulse_commit_error_string.argtypes = [ctypes.c_int]
    lib.pulse_commit_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtype, like):
    if t.device != like.device:
        raise ValueError(f"pulse_commit: {name} is on {t.device}, the pools on {like.device}")
    if t.dtype != dtype:
        raise ValueError(f"pulse_commit: {name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"pulse_commit: {name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"pulse_commit: {name} must be contiguous")


def launch(pools, data, heap, bounds, perms, *, scratch_words: int, shard0: int = 0,
           row0: int = 0):
    """Every shard's commit phase on PyTorch's current stream, in place on
    ``pools``, ``data`` and ``heap``: ``commit_key``, ``torch.sort``,
    ``commit_apply``, ``commit_tail``.  Does not synchronise.

    ``pools`` and ``heap`` hold shards ``shard0 .. shard0 + P - 1`` of the
    ``perms.shape[0]`` that ``bounds`` and ``perms`` describe, and
    ``data``'s first row is global row ``row0``."""
    if pools.device.type != "cuda":
        raise ValueError(f"pulse_commit kernel needs CUDA tensors, got {pools.device}")
    P, L, R = pools.shape
    cap, W = data.shape
    S = scratch_words
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"pulse_commit: node width {W} outside the kernel's 1..{MAX_WORDS}")
    if S < 1 or R != routing.record_width(S, _arena.mut_width(W)):
        raise ValueError(f"pulse_commit: records of {R} words do not carry {S} scratch words "
                         f"and a mutation payload of node width {W}")
    _check("pools", pools, (P, L, R), torch.int32, pools)
    _check("data", data, (cap, W), torch.int32, pools)
    n_shards = perms.shape[0]
    if not 0 <= shard0 <= n_shards - P or row0 < 0:
        raise ValueError(f"pulse_commit: pools of shards {shard0}..{shard0 + P - 1} and row "
                         f"{row0} for a mesh of {n_shards} shards")
    _check("heap", heap, (P, _arena.HEAP_WORDS), torch.int32, pools)
    _check("bounds", bounds, (n_shards + 1,), torch.int32, pools)
    _check("perms", perms, (n_shards,), torch.int32, pools)
    _ref.key_top(cap, L)  # raises when the order key would overflow int64
    lib = _library()
    with torch.cuda.device(pools.device):
        stream = torch.cuda.current_stream(pools.device).cuda_stream
        key = torch.empty((P, L), dtype=torch.int64, device=pools.device)
        _raise(lib, "commit_key", lib.pulse_commit_key_launch(
            pools.data_ptr(), bounds.data_ptr(), key.data_ptr(), P, L, R, S, cap, shard0, row0,
            stream))
        sk, order = torch.sort(key, dim=1, stable=True)
        _raise(lib, "commit_apply", lib.pulse_commit_apply_launch(
            pools.data_ptr(), data.data_ptr(), sk.data_ptr(), order.data_ptr(),
            perms.data_ptr(), P, L, R, S, W, cap, shard0, stream))
        _raise(lib, "commit_tail", lib.pulse_commit_tail_launch(
            pools.data_ptr(), data.data_ptr(), heap.data_ptr(), sk.data_ptr(),
            order.data_ptr(), bounds.data_ptr(), perms.data_ptr(), P, L, R, S, W, cap, shard0,
            row0, stream))


def _raise(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"pulse_commit: the {name} launch failed: CUDA error {err} "
                           f"({lib.pulse_commit_error_string(err).decode()})")
