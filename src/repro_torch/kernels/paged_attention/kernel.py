"""paged_attention on Hopper: build, bind and launch the CUDA kernel.

The kernel (``src/repro_torch/csrc/paged_attention.cu``) replaces the TPU
kernel ``src/repro/kernels/paged_attention/kernel.py::_paged_kernel``.
What bounds it on the card: bytes (every K and V element of the valid
pages is read once and used for G multiply-adds), so its least time is
those bytes over 3.35 TB/s.  The design is described in the source.  Built
and loaded by ``kernels._build``; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = _build.KernelSource("paged_attention", _build.CSRC / "paged_attention.cu")
HEAD_DIMS = (16, 32, 64, 112, 128)
GROUPS = (1, 2, 4, 8)  # query heads per KV head
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = SOURCE.load()
    fn = lib.paged_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # q, k_pages, v_pages, page_table, lengths, o
        + [ctypes.c_int] * 7  # B, H, Hk, D, N, page, P
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
    )
    fn.restype = ctypes.c_int
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, device, dtype, ndim):
    if t.device != device:
        raise ValueError(f"paged_attention: {name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"paged_attention: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"paged_attention: {name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"paged_attention: {name} must be contiguous and 16-byte aligned")


def launch(q, k_pages, v_pages, page_table, lengths, *, scale: float) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream; returns the
    output (B, H, D) in q's dtype.  Does not synchronise."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise ValueError(f"paged_attention: dtype {q.dtype} not in {list(DTYPES)}")
    for name, t, dt, nd in (("q", q, q.dtype, 3), ("k_pages", k_pages, q.dtype, 4),
                            ("v_pages", v_pages, q.dtype, 4),
                            ("page_table", page_table, torch.int32, 2),
                            ("lengths", lengths, torch.int32, 1)):
        _check(name, t, dev, dt, nd)
    B, H, D = q.shape
    N, page, Hk, Dk = k_pages.shape
    P = page_table.shape[1]
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pools {tuple(k_pages.shape)} "
                         f"/ {tuple(v_pages.shape)} disagree")
    if page_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("paged_attention: page_table and lengths must have B rows")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if H % Hk or H // Hk not in GROUPS:
        raise ValueError(f"paged_attention: H={H}, Hk={Hk}: query heads per KV head must be "
                         f"one of {GROUPS}")
    if N == 0 or page == 0:
        raise ValueError("paged_attention: empty page pool")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, Hk, D, N, page, P, float(scale),
            DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err} "
                           f"({lib.paged_attention_error_string(err).decode()})")
    return out
