"""Row gathers with a structured backward (counterpart of
``lpformer_tpu/ops/gather.py``).

Both gathers are ``torch.autograd.Function``s whose backward sums the
cotangent rows into the table's rows, in float32, cast once to the table's
dtype. The routing is the JAX package's, by size: from
``_SCATTER_MIN_ROWS`` flattened rows up the sum is ``ops/scatter.py``
(the hand-written CUDA kernel on a CUDA tensor, the counterpart of the
Pallas scatter the JAX package takes on a TPU); below it, an f32
``index_add_``, the counterpart of the JAX package's ``segment_sum``
branch (XLA there, not Pallas). ``gather_rows_valid`` passes its validity
mask to the sum, which drops the dead rows on either branch: their
cotangents are exactly zero by construction, and their ids need not lie
in range (the PE + attention ops, which read the key rows by id, sum
their table's gradient here too, over the context ids' pad id N with no
pad row).
"""
from __future__ import annotations

from typing import Optional

import torch

from lpformer_tpu_torch.ops import scatter

# flattened-row threshold of the JAX package (ops/gather.py:27)
_SCATTER_MIN_ROWS = 65536


def _rows_sum(ids, ct, n, valid):
    """sum of ct rows into their ids, f32 [n, D]; with ``valid`` (ids'
    shape) the dead rows are dropped, whatever their ids."""
    d = ct.shape[-1]
    if ids.numel() >= _SCATTER_MIN_ROWS:
        return scatter.scatter_rows_add(
            ids.to(torch.int32).contiguous(), ct.contiguous(), n,
            live=None if valid is None else valid.contiguous())
    rows, vals = ids.reshape(-1).long(), ct.reshape(-1, d).float()
    if valid is not None:
        # dead rows add an exact zero to row 0 (no host sync, as a
        # boolean selection would take on the card)
        live = valid.reshape(-1)
        rows = torch.where(live, rows, 0)
        vals = torch.where(live[:, None], vals, 0.0)
    out = torch.zeros((n, d), dtype=torch.float32, device=ct.device)
    return out.index_add_(0, rows, vals)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, valid):
        ctx.save_for_backward(ids, valid)
        ctx.n = table.shape[0]
        ctx.dtype = table.dtype
        return table[ids.long()]

    @staticmethod
    def backward(ctx, ct):
        ids, valid = ctx.saved_tensors
        return _rows_sum(ids, ct, ctx.n, valid).to(ctx.dtype), None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [N, D]; ids of any shape -> table[ids] [..., D]."""
    return _GatherRows.apply(table, ids, None)


def gather_rows_valid(
    table: torch.Tensor, ids: torch.Tensor, valid: Optional[torch.Tensor]
) -> torch.Tensor:
    """``gather_rows`` for an id table with a validity mask [ids.shape]:
    invalid ids must be in range, their rows are masked downstream, and
    the backward drops their (zero) cotangents."""
    return _GatherRows.apply(table, ids, valid)
