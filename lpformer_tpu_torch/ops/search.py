"""Batched sorted-row membership and value lookup (counterpart of
``lpformer_tpu/ops/search.py``).

The JAX package reduces a compare-all equality tensor with a dot, which
suits the TPU's vector units; here each query is a batched binary search
(``torch.searchsorted`` over the sorted rows), which is exact and has no
[B, Q, K] intermediate on any device.

Rows are sorted ascending and hold unique real ids, padded with the pad id
``num_nodes`` (PaddedRows). A real query therefore matches at most one
entry. A pad query matches the row's pad entries, whose values are 0.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


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
