"""ssd_scan on Hopper: build, bind and launch the CUDA kernel.

The source (``src/repro_torch/csrc/ssd_scan.cu``) replaces the TPU kernel
``src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel`` with three CUDA
kernels per call, the chunk axis parallel: each chunk's own state, the
state pass across chunks, and each chunk's output.  What bounds it on the
card: operations (the intra-chunk products take ~Q/2 multiply-adds per
element of C, B and x, each read once), so its least time is its FLOPs
over the f32 peak of 67 TFLOP/s, or, on the tensor cores it runs on, three
TF32 products per f32 one (3xTF32) at 495 TFLOP/s.  The design and its
tiles are described in the source.  Built and loaded by ``kernels._build``;
a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = _build.KernelSource("ssd_scan", _build.CSRC / "ssd_scan.cu")
STATE_DIMS = (16, 64, 128)  # N: the test shapes', the reduced and the full mamba2_780m
HEAD_DIMS = (16, 32, 64)  # dh
MAX_CHUNK = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x and y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = SOURCE.load()
    fn = lib.ssd_scan_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 9  # x, dt, A, B, C, y, S_out, and the scratch: states, cs
        + [ctypes.c_longlong] * 11  # strides of x (b, l, h), dt (b, l, h), B, C (b, l), A
        + [ctypes.c_int] * 8  # Bt, L, H, dh, N, chunk, heads per block, dtype
        + [ctypes.c_void_p]  # stream
    )
    fn.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, dtypes, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {like.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"ssd_scan: {name} is {t.dtype}, the kernel takes {list(dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def default_heads_per_block(Bt: int, L: int, H: int, chunk: int, device=None) -> int:
    """How many heads one block of the first and last kernel takes (and so
    share one chunk's ``C Bᵀ``) by default: enough blocks to fill the card's
    SMs once (one block per SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(H, -(-Bt * (L // chunk) * H // sms)))


def _aligned(t: torch.Tensor, dims: int) -> torch.Tensor:
    """``t`` itself when its base and its first ``dims`` strides are 16-byte
    aligned (the kernels copy rows 16 bytes at a time), else an aligned
    contiguous copy."""
    e = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * e % 16 == 0 for s in t.stride()[:dims]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def launch(x, dt, A, B, C, *, chunk: int, heads_per_block: int | None = None):
    """Launch the three kernels of one scan on PyTorch's current stream;
    returns y (Bt, L, H, dh) in x's dtype and the final state (Bt, H, N, dh)
    in f32.  ``heads_per_block`` (default: enough blocks to fill the card
    once) sets how many heads share one chunk's ``C Bᵀ``.  Does not
    synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, L, H, dh), got {tuple(x.shape)}")
    Bt, L, H, dh = x.shape
    if B.dim() != 3:
        raise ValueError(f"ssd_scan: B must be (B, L, N), got {tuple(B.shape)}")
    N = B.shape[2]
    _check("x", x, (Bt, L, H, dh), DTYPES, x)
    _check("dt", dt, (Bt, L, H), (torch.float32,), x)
    _check("A", A, (H,), (torch.float32,), x)
    _check("B", B, (Bt, L, N), (torch.float32,), x)
    _check("C", C, (Bt, L, N), (torch.float32,), x)
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: state dim N={N} not supported by the kernel "
                         f"(supported: {STATE_DIMS})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim {dh} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk={chunk} outside the kernel's 1..{MAX_CHUNK}")
    if L % chunk:
        raise ValueError(f"L={L} must divide chunk={chunk}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd_scan: x's last dim and B's and C's must be contiguous")
    lib = _library()
    th = (default_heads_per_block(Bt, L, H, chunk, x.device) if heads_per_block is None
          else heads_per_block)
    if not 1 <= th <= H:
        raise ValueError(f"ssd_scan: heads_per_block={th} outside 1..{H}")
    x, B, C = _aligned(x, 3), _aligned(B, 2), _aligned(C, 2)
    y = torch.empty((Bt, L, H, dh), dtype=x.dtype, device=x.device)
    S = torch.empty((Bt, H, N, dh), dtype=torch.float32, device=x.device)
    states = torch.empty((Bt, L // chunk, H, N, dh), dtype=torch.float32, device=x.device)
    cs = torch.empty((Bt, H, L), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), S.data_ptr(), states.data_ptr(), cs.data_ptr(), *x.stride()[:3],
            *dt.stride(), *B.stride()[:2], *C.stride()[:2], A.stride(0), Bt, L, H, dh, N,
            chunk, th, DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({lib.ssd_scan_error_string(err).decode()})")
    return y, S
