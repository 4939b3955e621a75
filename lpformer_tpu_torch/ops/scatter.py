"""Scatter-add of rows, the backward of a row gather (counterpart of
``lpformer_tpu/ops/pallas/scatter.py:scatter_rows_add``).

  out[i] = sum over rows r with ids[r] == i (and live[r]) of ct[r]

accumulated in float32. ``scatter_rows_add`` launches the hand-written CUDA
kernel ``csrc/scatter_rows_add.cu`` on CUDA tensors (built with nvcc for
sm_90a at first use, loaded with ctypes) and runs
``scatter_rows_add_plain``, an f32 ``index_add_`` over the live rows, on
CPU tensors. There is no fallback between the two. The kernel adds with
f32 atomics, so the order of the sums, and the last bits of the result,
change from run to run.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lpformer_tpu_torch.ops._cuda import build_cuda

_LIB = None


def build() -> Tuple[str, str]:
    """Compile the kernel (cached by source hash). Returns (library path,
    compiler output)."""
    return build_cuda("scatter_rows_add", "scatter_rows_add.cu")


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()[0])
        lib.scatter_rows_add.restype = ctypes.c_int
        lib.scatter_rows_add.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.scatter_rows_add_error_string.restype = ctypes.c_char_p
        lib.scatter_rows_add_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def scatter_rows_add_plain(
    ids: torch.Tensor, ct: torch.Tensor, n: int,
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The sum in torch ops: an f32 ``index_add_`` of the live rows."""
    d = ct.shape[-1]
    rows = ids.reshape(-1).long()
    vals = ct.reshape(-1, d).float()
    if live is not None:
        keep = live.reshape(-1)
        rows, vals = rows[keep], vals[keep]
    out = torch.zeros((n, d), dtype=torch.float32, device=ct.device)
    return out.index_add_(0, rows, vals)


def _check(ids, ct, n, live):
    if ct.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ct must be bfloat16 or float32, got {ct.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if tuple(ct.shape[:-1]) != tuple(ids.shape):
        raise ValueError(f"ct must have shape ids.shape + (D,), got "
                         f"{tuple(ct.shape)} for ids {tuple(ids.shape)}")
    tensors = {"ids": ids, "ct": ct}
    if live is not None:
        if live.dtype != torch.bool or tuple(live.shape) != tuple(ids.shape):
            raise ValueError("live must be a bool tensor of ids' shape")
        tensors["live"] = live
    for name, t in tensors.items():
        if t.device != ct.device:
            raise ValueError(f"{name} is on {t.device}, ct on {ct.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")


def scatter_rows_add(
    ids: torch.Tensor,     # int32, any shape
    ct: torch.Tensor,      # ids.shape + (D,), bf16 or f32
    n: int,
    live: Optional[torch.Tensor] = None,   # bool, ids.shape
) -> torch.Tensor:
    """[n, D] float32 sums of the (live) rows of ``ct`` into their ids.
    Rows with live=False are dropped, as are ids outside [0, n). CUDA
    tensors launch the kernel (``scatter_rows_add.launches`` counts the
    launches); CPU tensors run the plain version."""
    if ct.device.type == "cpu":
        return scatter_rows_add_plain(ids, ct, n, live)
    _check(ids, ct, n, live)
    d = ct.shape[-1]
    m = ids.numel()
    out = torch.zeros((n, d), dtype=torch.float32, device=ct.device)
    lib = _load()
    with torch.cuda.device(ct.device):
        err = lib.scatter_rows_add(
            ids.data_ptr(), ct.data_ptr(),
            None if live is None else live.data_ptr(), out.data_ptr(),
            m, d, n, int(ct.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("scatter_rows_add launch failed: "
                           + lib.scatter_rows_add_error_string(err).decode())
    scatter_rows_add.launches += 1
    return out


scatter_rows_add.launches = 0
