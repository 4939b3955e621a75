"""Fused one-hot lookup (counterpart of
``lpformer_tpu/ops/pallas/lookup.py:fused_lookup``).

  out[b, l, q] = sum_k (queries[b, q] == rows[b, k]) * lanes[b, l, k]

in exact int32 arithmetic with wraparound: the batched membership / value
reduction behind ``ops/search.py:fused_row_member_values``, the opt-in
route of every row lookup of context extraction
(``LPFORMER_FUSED_LOOKUP=1``). Row ids are unique per row, so a real query
matches at most one entry and its sums are that entry's lane values, bit
for bit; a pad query matches every pad entry of its row, and its sums may
wrap (callers mask those lanes).

``fused_lookup`` launches the hand-written CUDA kernel
``csrc/fused_lookup.cu`` on CUDA tensors (built with nvcc for sm_90a at
first use, loaded with ctypes) and runs ``fused_lookup_plain``, the same
sums in torch ops, on CPU tensors. There is no fallback between the two.
"""
from __future__ import annotations

from typing import Tuple

import torch

from lpformer_tpu_torch.ops._cuda import bind, build_cuda

_LIB = None
# elements of the [b, L, Q, K] int64 intermediate of the plain version
_PLAIN_CHUNK = 1 << 25


def build() -> Tuple[str, str]:
    """Compile the kernel (cached by source hash). Returns (library path,
    compiler output)."""
    return build_cuda("fused_lookup", "fused_lookup.cu")


def _load():
    global _LIB
    if _LIB is None:
        _LIB = bind(build()[0], "fused_lookup", 4, 4,
                    "fused_lookup_error_string")
    return _LIB


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 sums as int32 with two's-complement wraparound, as an int32
    accumulator (JAX's int32 sum) gives them."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def fused_lookup_plain(rows: torch.Tensor, queries: torch.Tensor,
                       lanes: torch.Tensor) -> torch.Tensor:
    """The sums in torch ops: the [B, L, Q, K] selection summed over K in
    int64 (``torch.sum`` of int32 promotes to int64), then wrapped to int32;
    in batch chunks that bound the intermediate."""
    b, k = rows.shape
    q, n_l = queries.shape[1], lanes.shape[1]
    out = torch.empty((b, n_l, q), dtype=torch.int32, device=rows.device)
    step = max(1, _PLAIN_CHUNK // max(1, n_l * q * k))
    for lo in range(0, b, step):
        hi = min(lo + step, b)
        eq = queries[lo:hi, :, None] == rows[lo:hi, None, :]      # [b, Q, K]
        sel = torch.where(eq[:, None], lanes[lo:hi, :, None, :].long(), 0)
        out[lo:hi] = wrap_int32(sel.sum(-1))
    return out


def _check(rows, queries, lanes):
    for name, t, dim in (("rows", rows, 2), ("queries", queries, 2),
                         ("lanes", lanes, 3)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dims, got {t.dim()}")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, k = rows.shape
    if (queries.shape[0] != b or lanes.shape[0] != b or lanes.shape[2] != k
            or k < 1 or lanes.shape[1] < 1):
        raise ValueError(f"shapes rows {tuple(rows.shape)}, queries "
                         f"{tuple(queries.shape)}, lanes {tuple(lanes.shape)}"
                         f" are not [B, K], [B, Q], [B, L >= 1, K >= 1]")


def fused_lookup(
    rows: torch.Tensor,      # [B, K] int32, ids unique per row
    queries: torch.Tensor,   # [B, Q] int32
    lanes: torch.Tensor,     # [B, L, K] int32 value lanes (f32 bit patterns ok)
) -> torch.Tensor:           # [B, L, Q] int32
    """The int32 lane sums of each query's matches. CUDA tensors launch the
    kernel (``fused_lookup.launches`` counts the launches); CPU tensors run
    the plain version."""
    if rows.device.type == "cpu":
        return fused_lookup_plain(rows, queries, lanes)
    _check(rows, queries, lanes)
    b, k = rows.shape
    q, n_l = queries.shape[1], lanes.shape[1]
    out = torch.empty((b, n_l, q), dtype=torch.int32, device=rows.device)
    lib = _load()
    with torch.cuda.device(rows.device):
        err = lib.fused_lookup(
            rows.data_ptr(), queries.data_ptr(), lanes.data_ptr(),
            out.data_ptr(), b, k, q, n_l,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fused_lookup launch failed: "
                           + lib.fused_lookup_error_string(err).decode())
    fused_lookup.launches += 1
    return out


fused_lookup.launches = 0
