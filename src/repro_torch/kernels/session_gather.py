"""Session-arena pack/unpack on the H100 (port of
``repro/kernels/session_gather.py``).

Replaces the Pallas TPU kernels ``session_gather`` and ``session_scatter``
in ``repro/kernels/session_gather.py``.  The kernel is CUDA C++ in
``csrc/session_gather.cu`` (one kernel, both directions); its header says
what bounds it on the card and what its design does about that.  This
module checks the arguments, treats each slab leaf as an
``(S, row_bytes)`` byte matrix, passes the slot ids by value in the
launch's parameter struct (at most ``MAX_IDS``) and launches on PyTorch's
current stream.  The plain versions are ``ref.session_gather_ref`` and
``ref.session_scatter_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build

MAX_IDS = 256

gather_launches = 0    # session_gather kernel launches (chip_smoke reads them)
scatter_launches = 0   # session_scatter kernel launches


class _CopyParams(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row_bytes", ctypes.c_longlong), ("n", ctypes.c_int),
                ("scatter", ctypes.c_int), ("unit", ctypes.c_int),
                ("ids", ctypes.c_int * MAX_IDS)]


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.library("session_gather")
        lib.session_copy_abi_size.restype = ctypes.c_int
        lib.session_copy_abi_size.argtypes = []
        if lib.session_copy_abi_size() != ctypes.sizeof(_CopyParams):
            raise RuntimeError("session_gather: C and ctypes parameter "
                               "layouts differ")
        fn = lib.session_copy_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_CopyParams), ctypes.c_int,
                       ctypes.c_void_p]
        _fn = fn
    return _fn


def check_ids(ids: Sequence[int], n_rows: int) -> list:
    """Host slot ids as a list of ints, each in ``[0, n_rows)``.  Raises
    otherwise: the reference's ``jnp.take`` would clamp an id out of
    range, and the kernel would read or write out of bounds."""
    ids = [int(i) for i in ids]
    bad = [i for i in ids if not 0 <= i < n_rows]
    if bad:
        raise IndexError(f"slot ids {bad} out of range [0, {n_rows})")
    return ids


def _launch(src: torch.Tensor, dst: torch.Tensor, ids: list,
            row_bytes: int, scatter: bool) -> None:
    if not 1 <= len(ids) <= MAX_IDS:
        raise ValueError(f"1..{MAX_IDS} slot ids per launch, got {len(ids)}")
    p = _CopyParams()
    p.src, p.dst = src.data_ptr(), dst.data_ptr()
    p.row_bytes, p.n, p.scatter = row_bytes, len(ids), int(scatter)
    unit = 16
    while (src.data_ptr() | dst.data_ptr() | row_bytes) % unit:
        unit //= 2
    p.unit = unit
    p.ids[:len(ids)] = ids
    dev = src.device
    err = _launcher()(ctypes.byref(p),
                      dev.index if dev.index is not None
                      else torch.cuda.current_device(),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"session_gather kernel launch failed: "
                           f"cudaError {err}")


def _check_slab(slab: torch.Tensor, name: str) -> None:
    if not slab.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if slab.ndim < 1 or not slab.is_contiguous():
        raise ValueError(f"{name}: the slab must be a contiguous tensor "
                         "with a leading row axis")


def session_gather(slab: torch.Tensor, ids: Sequence[int],
                   out: torch.Tensor = None) -> torch.Tensor:
    """Launch the gather: slab (S, ...) on the card, ``ids`` B host ints
    -> (B, ...) rows (written into ``out`` when given: a contiguous
    tensor of that shape and dtype on the slab's device)."""
    global gather_launches
    _check_slab(slab, "session_gather")
    ids = check_ids(ids, slab.shape[0])
    shape = (len(ids),) + tuple(slab.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=slab.dtype, device=slab.device)
    elif tuple(out.shape) != shape or out.dtype != slab.dtype \
            or out.device != slab.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {slab.dtype} tensor of "
                         f"shape {shape} on {slab.device}")
    row_bytes = slab[0].numel() * slab.element_size()
    if row_bytes:
        _launch(slab, out, ids, row_bytes, scatter=False)
        gather_launches += 1
    return out


def session_scatter(slab: torch.Tensor, ids: Sequence[int],
                    rows: torch.Tensor) -> torch.Tensor:
    """Launch the scatter: ``slab[ids] = rows`` IN PLACE; returns the
    slab.  rows (B, ...) must match the slab's row shape and dtype and lie
    on its device (non-contiguous rows are copied first)."""
    global scatter_launches
    _check_slab(slab, "session_scatter")
    ids = check_ids(ids, slab.shape[0])
    if tuple(rows.shape) != (len(ids),) + tuple(slab.shape[1:]) \
            or rows.dtype != slab.dtype or rows.device != slab.device:
        raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype} on "
                         f"{rows.device} do not match {len(ids)} rows of "
                         f"the slab {tuple(slab.shape)} {slab.dtype} on "
                         f"{slab.device}")
    rows = rows.contiguous()
    row_bytes = slab[0].numel() * slab.element_size()
    if row_bytes:
        _launch(rows, slab, ids, row_bytes, scatter=True)
        scatter_launches += 1
    return slab


def cost(rows: torch.Tensor) -> tuple:
    """(FLOPs, bytes) of one gather or scatter of ``rows`` (what ``ops``
    charges on the meta device): no arithmetic, each row read once and
    written once."""
    return 0.0, float(2 * rows.numel() * rows.element_size())
