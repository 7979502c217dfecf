"""pulse_commit on Hopper: the canonical order in torch ops, then the CUDA
kernel that walks it.

The source (``src/repro_torch/csrc/pulse_commit.cu``) replaces the JAX
package's ``_commit_phase`` (``src/repro/core/routing.py:407``), XLA with no
Pallas kernel: one block of one warp per shard walks that shard's eligible
records in order, its lanes splitting each row's words.  What bounds it is
the chain of dependent accesses, one record after the next; its bytes bound
(each eligible record and each row it touches moved once) is far below.
The record layout, opcodes and heap registers reach the source as ``-D``
defines from the port's modules.  Built and loaded by ``kernels._build``;
a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import arena as _arena
from repro_torch.core import iterator as _iterator
from repro_torch.core import routing
from repro_torch.kernels import _build

MAX_WORDS = 64  # a node row is at most 256 B

LAYOUT_DEFINES = dict(
    PC_F_STATUS=routing.F_STATUS, PC_F_SCRATCH=routing.F_SCRATCH,
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
    fn = lib.pulse_commit_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pulse_commit_error_string.argtypes = [ctypes.c_int]
    lib.pulse_commit_error_string.restype = ctypes.c_char_p
    return lib


def commit_order(pools: torch.Tensor, bounds: torch.Tensor, *, scratch_words: int,
                 capacity: int):
    """Each shard's commit order and its count of eligible records, on the
    pools' device with no host read: ``(order (P, L) int64, n (P,) int32)``.

    A record is eligible at shard ``s`` when it stages a mutation, is not
    EMPTY, and either its target lies in ``s``'s rows (STORE, CAS, FREE) or
    ``s`` is its home (ALLOC).  The order is one sort of the key
    ``(class * capacity + slot) * L + id`` (class 0 STORE/CAS, 1 FREE, 2
    ALLOC; slot 0 for an ALLOC), with a key past all of them for the rest:
    the JAX package's four-pass lexsort (eligible first, then class, slot,
    id) whenever the ids lie in ``[0, L)``, as placement gives them."""
    P, L, R = pools.shape
    top = 3 * capacity * L
    if top >= 1 << 62:
        raise ValueError(f"pulse_commit: the order key 3 * {capacity} * {L} overflows int64")
    MB = routing.F_SCRATCH + scratch_words
    m_op = pools[..., MB]
    tgt = pools[..., MB + 1]
    me = torch.arange(P, dtype=torch.int32, device=pools.device)[:, None]
    pend = (m_op != _arena.M_NONE) & (pools[..., routing.F_STATUS] != _iterator.STATUS_EMPTY)
    is_alloc = m_op == _arena.M_ALLOC
    local = (tgt >= bounds[:-1, None]) & (tgt < bounds[1:, None])
    eligible = pend & torch.where(is_alloc, pools[..., routing.F_HOME] == me, local)
    klass = torch.where(is_alloc, 2, torch.where(m_op == _arena.M_FREE, 1, 0)).long()
    slot = torch.where(is_alloc, 0, tgt).long()
    key = (klass * capacity + slot) * L + pools[..., routing.F_ID].long()
    key = torch.where(eligible, key, top)
    order = torch.sort(key, dim=1, stable=True).indices
    return order, eligible.sum(dim=1, dtype=torch.int32)


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


def launch(pools, data, heap, bounds, perms, order, n_eligible, *, scratch_words: int):
    """Launch the kernel on PyTorch's current stream: every shard's commit
    phase, in place on ``pools``, ``data`` and ``heap``.  Does not
    synchronise."""
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
    _check("heap", heap, (P, _arena.HEAP_WORDS), torch.int32, pools)
    _check("bounds", bounds, (P + 1,), torch.int32, pools)
    _check("perms", perms, (P,), torch.int32, pools)
    _check("order", order, (P, L), torch.int64, pools)
    _check("n_eligible", n_eligible, (P,), torch.int32, pools)
    lib = _library()
    with torch.cuda.device(pools.device):
        err = lib.pulse_commit_launch(
            pools.data_ptr(), data.data_ptr(), heap.data_ptr(), order.data_ptr(),
            n_eligible.data_ptr(), bounds.data_ptr(), perms.data_ptr(), P, L, R, S, W,
            torch.cuda.current_stream(pools.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pulse_commit launch failed: CUDA error {err} "
                           f"({lib.pulse_commit_error_string(err).decode()})")
