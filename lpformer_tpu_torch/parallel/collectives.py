"""The collectives of the mesh step, with the gradients that ``shard_map``'s
transpose gives the JAX package (sharded_step.py:28-31). No JAX
counterpart of its own.

Gradients are defined for a SUM of per-rank losses: every rank holds its
own copy of each replicated tensor, and each collective's backward is its
adjoint. A caller whose per-rank losses add up to the global loss gets,
after one all-reduce of the parameter gradients over the mesh, the
global loss's gradient:

  * ``all_gather`` (tiled on dim 0) -> backward: reduce-scatter (sum);
  * ``psum`` (all-reduce sum) -> backward: all-reduce (sum);
  * ``pmax`` takes no gradient (the caller detaches its input);
  * ``fetch_rows`` (the context-row exchange) and the integer gathers
    carry none.

On NCCL the sums are the backend's own all-reduce and reduce-scatter
(every rank gets the same bits). On gloo every rank gathers the group's
tensors and sums them itself in rank order, since gloo's all-reduce
differs by an ulp from rank to rank and the replicated parameters must
not drift; a CUDA tensor travels through the host there (several ranks
sharing one card, where NCCL cannot run). A group of one rank is the
identity.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group):
    """(t as the group's backend takes it, a function back to t's device)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        dev = t.device
        return t.cpu(), lambda x: x.to(dev)
    return t, lambda x: x


def _gathered(t: torch.Tensor, group) -> torch.Tensor:
    """[n, *t.shape]: the group's ``t`` (equal shapes), in rank order."""
    n = _size(group)
    x, back = _staged(t.detach().contiguous(), group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return back(torch.stack(parts))


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: the sum (or ``op`` "max") of ``t`` over the group, no
    gradient, the same bits on every rank: NCCL's all-reduce, or on gloo
    the gathered tensors reduced by every rank itself in rank order."""
    if _size(group) == 1:
        return t.clone()
    if _nccl(group):
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
        return out
    parts = _gathered(t, group)
    if op == "max":
        return parts.amax(dim=0)
    return parts.sum(dim=0, dtype=t.dtype)


def all_gather_nograd(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` (equal shapes) concatenated on dim 0 in rank
    order (no gradient)."""
    if _size(group) == 1:
        return t.clone()
    return _gathered(t, group).flatten(0, 1)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's block (dim 0, rank order) of the group's sum of ``t``
    (no gradient)."""
    n = _size(group)
    if n == 1:
        return t.clone()
    if _nccl(group):
        out = torch.empty((t.shape[0] // n,) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, t.detach().contiguous(), group=group)
        return out
    total = all_reduce(t, group)
    per = t.shape[0] // n
    r = dist.get_rank(group)
    return total[r * per:(r + 1) * per].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_nograd(t, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-gather on dim 0; backward: reduce-scatter."""
    if _size(group) == 1:
        return t
    return _AllGather.apply(t, group)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum; backward: all-reduce sum."""
    if _size(group) == 1:
        return t
    return _PSum.apply(t, group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce max of a detached tensor (no gradient)."""
    return all_reduce(t.detach(), group, op="max")


def _as_lanes(t: torch.Tensor) -> torch.Tensor:
    """[R, K] as int32 lanes, exactly: a float's bit pattern (f32), an
    integer's value (int32 ids and ranks), a bool as 0 / 1."""
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    return t.to(torch.int32)


def _from_lanes(lanes: torch.Tensor, dtype) -> torch.Tensor:
    lanes = lanes.contiguous()
    if dtype == torch.float32:
        return lanes.view(torch.float32)
    return lanes.to(dtype)


def fetch_rows(
    ids: torch.Tensor, tables: Sequence[Optional[torch.Tensor]],
    rows_per: int, group,
) -> List[Optional[torch.Tensor]]:
    """The rows ``ids`` [R] of tables row-sharded over ``group``: rank k
    of the group holds rows [k * rows_per, (k + 1) * rows_per) of each
    table ([rows_per, K_i] here, f32, int32 or bool; None passes through).
    Returns one [R, K_i] per table, bit for bit the rows of the whole
    tables. Every rank asks for the same number R of rows.

    The ids go round the group (an all-gather of [R] ints, read on the
    host); each row then travels once, from its one owner to the rank
    that asked for it, in one ``all_to_all_single`` of int32 lanes that
    packs every table's row side by side. No arithmetic touches a row."""
    live = [t for t in tables if t is not None]
    n = _size(group)
    me = dist.get_rank(group)
    r = ids.shape[0]
    ids_all = all_gather_nograd(ids.to(torch.int64), group).cpu().numpy()
    owner = ids_all // rows_per                          # [n * R]
    blocks, owners = ids_all.reshape(n, r), owner.reshape(n, r)
    # the rows this rank sends to rank j: j's requests it owns, in order
    send_rows = [blocks[j][owners[j] == me] - me * rows_per
                 for j in range(n)]
    send_idx = torch.as_tensor(np.concatenate(send_rows),
                               device=ids.device)
    widths = [t.shape[1] for t in live]
    payload = torch.cat([_as_lanes(t[send_idx]) for t in live], dim=1)
    # this rank's requests grouped by owner, in order within each owner
    order = np.argsort(owners[me], kind="stable")
    recv_splits = np.bincount(owners[me], minlength=n).tolist()
    send_splits = [len(x) for x in send_rows]
    if n == 1:
        recv = payload
    else:
        x, back = _staged(payload.contiguous(), group)
        out = torch.empty((r, x.shape[1]), dtype=x.dtype, device=x.device)
        dist.all_to_all_single(out, x, recv_splits, send_splits,
                               group=group)
        recv = back(out)
    packed = torch.empty_like(recv)
    packed[torch.as_tensor(order, device=recv.device)] = recv
    cols = torch.split(packed, widths, dim=1)
    got = iter(_from_lanes(c, t.dtype) for c, t in zip(cols, live))
    return [None if t is None else next(got) for t in tables]
