"""Masked and segment reductions (counterpart of
``lpformer_tpu/ops/segment.py``).

The model's layout is dense: per-link context tables of static shape
[B, C] with validity masks, so its softmax is the masked dense
``masked_softmax``. The flat ragged segment variants serve a flat layout
(one row per (link, context node) pair, ``seg_ids`` naming the link).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def masked_softmax(
    logits: torch.Tensor, valid: torch.Tensor, axis: int = 1
) -> torch.Tensor:
    """Softmax over ``axis`` restricted to ``valid`` entries. A row with no
    valid entry gives exactly 0 everywhere (the reference's
    scatter-of-nothing into zeros)."""
    masked = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
    m = masked.amax(dim=axis, keepdim=True).clamp_min(_NEG_INF / 2)
    e = torch.exp(masked - m) * valid.to(logits.dtype)
    denom = e.sum(dim=axis, keepdim=True)
    return e / denom.clamp_min(1e-16)


def masked_count(valid: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Per-row count of valid entries as float32 [B, 1]: the structure
    counts of the reference's get_count / get_num_ppr_thresh
    (src/models/link_transformer.py:359-386)."""
    return valid.float().sum(dim=axis, keepdim=True)


def segment_sum(
    x: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    indices_are_sorted: bool = True,
) -> torch.Tensor:
    """Sum of the rows of ``x`` [L, ...] into ``num_segments`` segments by
    ``seg_ids`` [L] (each in [0, num_segments)); an empty segment is 0.
    ``indices_are_sorted`` is the JAX signature's hint and changes
    nothing here."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add_(0, seg_ids.long(), x)


def segment_softmax(
    logits: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    valid: Optional[torch.Tensor] = None,
    indices_are_sorted: bool = True,
) -> torch.Tensor:
    """Softmax over ragged segments (the flat layout): logits [L] or
    [L, H], seg_ids [L]; entries with ``valid`` False get exactly 0, and
    so does every entry of a segment with no valid entry."""
    v = None
    if valid is not None:
        v = valid if logits.dim() == valid.dim() else valid[:, None]
        logits = torch.where(v, logits, torch.full_like(logits, _NEG_INF))
    # seg_ids [L] broadcast over the trailing dims of logits
    ids = seg_ids.long().reshape(
        (-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
    seg_max = torch.full((num_segments,) + tuple(logits.shape[1:]),
                         -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, ids, logits, "amax",
                                     include_self=True)
    seg_max = seg_max.clamp_min(_NEG_INF / 2)
    e = torch.exp(logits - seg_max[seg_ids.long()])
    if v is not None:
        e = e * v.to(e.dtype)
    denom = segment_sum(e, seg_ids, num_segments)
    return e / denom[seg_ids.long()].clamp_min(1e-16)
