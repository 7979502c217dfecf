"""flash_attention on Hopper: build, bind and launch the CUDA kernel.

The kernel (``src/repro_torch/csrc/flash_attention.cu``) replaces the TPU
kernel ``src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel``.
What bounds it on the card: operations (about 4*D multiply-adds per
(query, key) pair it keeps, against each input read once), so its least
time is its FLOPs over the f32 peak of 67 TFLOP/s, or, on the tensor cores
it runs on, three TF32 products per f32 one (3xTF32) at 495 TFLOP/s.  The
design and its tiles are described in the source.  Built and loaded by
``kernels._build``; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = _build.KernelSource("flash_attention", _build.CSRC / "flash_attention.cu")
HEAD_DIMS = (16, 32, 64, 112, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = SOURCE.load()
    fn = lib.flash_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4  # q, k, v, o
        + [ctypes.c_longlong] * 12  # (b, h, l) strides of q, k, v, o
        + [ctypes.c_int] * 7  # B, H, Hk, Lq, Lk, D, causal
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {like.dtype}")
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must have 4 dims, got {tuple(t.shape)}")
    if (t.stride(3) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous last dim and 16-byte aligned "
            f"rows, got strides {t.stride()}"
        )


def launch(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """Launch the kernel once on PyTorch's current stream; returns the
    output (B, H, Lq, D) in q's dtype.  Does not synchronise."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {list(DTYPES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    B, H, Lq, D = q.shape
    _, Hk, Lk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if H % Hk:
        raise ValueError(f"H={H} not a multiple of Hk={Hk}")
    if Lq == 0 or Lk == 0:
        raise ValueError("flash_attention: empty sequence")
    out = torch.empty((B, H, Lq, D), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            B, H, Hk, Lq, Lk, D, int(causal), float(scale), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    return out
