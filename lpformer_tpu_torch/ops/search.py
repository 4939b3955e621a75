"""Batched sorted-row membership and value lookup (counterpart of
``lpformer_tpu/ops/search.py``).

The JAX package reduces a compare-all equality tensor with a dot, which
suits the TPU's vector units; here each query is a batched binary search
(``torch.searchsorted`` over the sorted rows), which is exact and has no
[B, Q, K] intermediate on any device.

Rows are sorted ascending and hold unique real ids, padded with the pad id
``num_nodes`` (PaddedRows). A real query therefore matches at most one
entry. A pad query matches the row's pad entries, whose values are 0.

The opt-in route (``LPFORMER_FUSED_LOOKUP=1``, CUDA tensors only, as the
JAX package's switch is TPU only) sends every lookup through the fused
one-hot kernel instead (``fused_row_member_values``, ops/lookup.py). On
real queries both routes give the same bits; a pad query's values differ
(the fused route sums every pad entry, the search reads one), and the
callers mask those lanes.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch

from lpformer_tpu_torch.ops.lookup import fused_lookup


def fused_lookup_enabled(rows: torch.Tensor) -> bool:
    """The opt-in switch of the fused route: LPFORMER_FUSED_LOOKUP=1 and
    rows on a CUDA device."""
    return (os.environ.get("LPFORMER_FUSED_LOOKUP", "0") == "1"
            and rows.device.type == "cuda")


def _as_i32_bits(va: torch.Tensor) -> torch.Tensor:
    """A value array as int32 lanes: the bit pattern of a float (as f32),
    the value of an integer or bool."""
    if va.dtype.is_floating_point:
        return va.float().view(torch.int32)
    return va.to(torch.int32)


def _from_i32_bits(raw: torch.Tensor, dtype) -> torch.Tensor:
    if dtype.is_floating_point:
        return raw.contiguous().view(torch.float32).to(dtype)
    return raw.to(dtype)


def fused_row_member_values(
    rows: torch.Tensor,                     # [B, K] sorted ids, pad = n
    queries: torch.Tensor,                  # [B, Q]
    value_arrays: Sequence[torch.Tensor] = (),   # each [B, K]
    defaults: Sequence = (),
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """:func:`row_member_values` through ``fused_lookup``: each value array
    rides one int32 lane (f32 values as their bit patterns), and a ones
    lane counts the matches for the membership."""
    b, k = rows.shape
    cols = [_as_i32_bits(va) for va in value_arrays]
    cols.append(torch.ones((b, k), dtype=torch.int32, device=rows.device))
    out = fused_lookup(rows.to(torch.int32).contiguous(),
                       queries.to(torch.int32).contiguous(),
                       torch.stack(cols, dim=1))               # [B, L, Q]
    found = out[:, -1, :] > 0
    out_vals = []
    for i, va in enumerate(value_arrays):
        v = _from_i32_bits(out[:, i, :], va.dtype)
        if defaults and defaults[i] is not None:
            v = torch.where(found, v, torch.as_tensor(
                defaults[i], dtype=va.dtype, device=v.device))
        out_vals.append(v)
    return found, out_vals


def row_member_values(
    rows: torch.Tensor,                     # [B, K] sorted ids, pad = n
    queries: torch.Tensor,                  # [B, Q]
    value_arrays: Sequence[torch.Tensor] = (),   # each [B, K]
    defaults: Sequence = (),
    with_found: bool = True,
) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """Membership of each query in its row, and each value array's entry at
    the match (``defaults[i]`` where absent; 0 when no default is given,
    which the pad entries' zero values make consistent for pad queries)."""
    if fused_lookup_enabled(rows):
        found, out_vals = fused_row_member_values(rows, queries, value_arrays,
                                                  defaults)
        return (found if with_found else None), out_vals
    k = rows.shape[1]
    queries = queries.to(rows.dtype)
    pos = torch.searchsorted(rows, queries).clamp_(max=k - 1)
    found = torch.gather(rows, 1, pos) == queries
    out_vals = []
    for i, va in enumerate(value_arrays):
        v = torch.gather(va, 1, pos)
        fill = defaults[i] if defaults and defaults[i] is not None else 0
        fill = torch.as_tensor(fill, dtype=v.dtype, device=v.device)
        out_vals.append(torch.where(found, v, fill))
    return (found if with_found else None), out_vals


def row_contains(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Membership only."""
    found, _ = row_member_values(rows, queries)
    return found


def row_lookup(
    rows: torch.Tensor, vals: torch.Tensor, queries: torch.Tensor, default
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found, value-or-default) for each query."""
    found, (v,) = row_member_values(rows, queries, (vals,), (default,))
    return found, v


def row_lookup_value(
    rows: torch.Tensor, vals: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """Value lookup with an implicit 0.0 for absent queries."""
    _, (v,) = row_member_values(rows, queries, (vals,), with_found=False)
    return v
