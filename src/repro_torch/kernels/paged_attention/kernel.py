"""paged_attention on Hopper: build, bind and launch the CUDA kernels.

The kernels (``src/repro_torch/csrc/paged_attention.cu``) replace the TPU
kernel ``src/repro/kernels/paged_attention/kernel.py::_paged_kernel``.
What bounds them on the card: bytes (every K and V element of the valid
pages is read once and used for 2 G flops), so their least time is those
bytes over 3.35 TB/s.  A call is a split-K flash-decode: ``S`` blocks per
(sequence, KV head) each take a contiguous range of the sequence's page
slots (``split_ranges``) and write a partial softmax to a workspace, and a
second, small kernel merges them; with ``S = 1`` the first kernel writes
the output and the merge is not launched.  ``split_plan`` picks ``S`` on
the host from the shapes alone: the wrapper never reads ``lengths`` or the
page table, so a call makes no device-to-host sync.  The design is
described in the source.  Built and loaded by ``kernels._build``; a build
or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = _build.KernelSource("paged_attention", _build.CSRC / "paged_attention.cu")
HEAD_DIMS = (16, 32, 64, 112, 128)
MAX_GROUP = 16  # query heads per KV head (the kernel's kMaxG: shared memory per head)
MAX_SPLIT_PAGES = 256  # page slots of one split (the kernel's kMaxSplitPages)
BLOCKS_PER_SM = 2  # split blocks the plan aims for on each SM
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(B: int, Hk: int, P: int, n_sm: int, *, blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Splits ``S`` per (sequence, KV head): as many as fill ``n_sm *
    blocks_per_sm`` blocks in one wave (at least 1, at most ``P``), and at
    least ``ceil(P / MAX_SPLIT_PAGES)`` so that a split's page ids fit the
    kernel's table."""
    if P <= 0:
        return 1
    S = max(1, (n_sm * blocks_per_sm) // max(1, B * Hk))
    return min(max(S, -(-P // MAX_SPLIT_PAGES)), P)


def split_ranges(length: int, page: int, P: int, S: int) -> list[tuple[int, int]]:
    """The page ranges ``[p0, p1)`` that the ``S`` splits of one sequence
    take, as the kernel computes them (``split_slots`` in the source): split
    ``s`` owns page slots ``[s * ceil(P/S), (s + 1) * ceil(P/S))``, cut at the
    sequence's ``ceil(min(max(length, 0), P * page) / page)`` valid pages; a
    split past the last valid page has an empty range and exits at once."""
    n = -(-min(max(length, 0), P * page) // page)
    per = -(-P // S)
    return [(min(s * per, n), min(s * per + per, n)) for s in range(S)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = SOURCE.load()
    fn = lib.paged_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 7  # q, k_pages, v_pages, page_table, lengths, o, workspace
        + [ctypes.c_int] * 8  # B, H, Hk, D, N, page, P, S
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
    )
    fn.restype = ctypes.c_int
    occ = lib.paged_attention_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, err: int, what: str):
    raise RuntimeError(f"paged_attention {what} failed: CUDA error {err} "
                       f"({lib.paged_attention_error_string(err).decode()})")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, D: int, G: int, dtype_code: int) -> int:
    """Split blocks one SM holds at once (the occupancy API, cached)."""
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.paged_attention_blocks_per_sm(D, G, dtype_code, ctypes.byref(blocks))
    if err != 0:
        _raise(lib, err, "occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"paged_attention: no split block of D={D}, G={G} fits an SM")
    return blocks.value


def launch_plan(device: torch.device, B: int, H: int, Hk: int, D: int, P: int,
                dtype: torch.dtype) -> int:
    """The ``S`` that ``launch`` uses for these shapes on ``device``."""
    per_sm = min(BLOCKS_PER_SM, _blocks_per_sm(device.index, D, H // Hk, DTYPES[dtype]))
    return split_plan(B, Hk, P, _sm_count(device.index), blocks_per_sm=per_sm)


def query_group(H: int, Hk: int) -> int:
    """G = H/Hk, the query heads that share a KV head: any whole number up
    to ``MAX_GROUP`` (the kernel keeps q, scores and the running softmax of
    every head of the group in shared memory); ValueError beyond."""
    if Hk <= 0 or H % Hk:
        raise ValueError(f"paged_attention: H={H} is not a multiple of Hk={Hk}")
    if H // Hk > MAX_GROUP:
        raise ValueError(f"paged_attention: G = H/Hk = {H // Hk} query heads per KV head; the "
                         f"kernel takes at most {MAX_GROUP}")
    return H // Hk


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
    """Launch the kernels of one call on PyTorch's current stream; returns
    the output (B, H, D) in q's dtype.  Does not synchronise."""
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
    query_group(H, Hk)
    if N == 0 or page == 0:
        raise ValueError("paged_attention: empty page pool")
    if B > 65535 or (P + 1) * page >= 2**31:
        raise ValueError(f"paged_attention: B={B} or P*page={P * page} beyond the kernel's grid "
                         f"and int32 positions")
    out = torch.empty_like(q)
    if B == 0:
        return out
    S = launch_plan(dev, B, H, Hk, D, P, q.dtype)
    ws = torch.empty(B * H * S * (D + 2), dtype=torch.float32, device=dev) if S > 1 else None
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
            B, H, Hk, D, N, page, P, S, float(scale), DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        _raise(lib, err, "launch")
    return out
