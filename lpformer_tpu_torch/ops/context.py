"""Per-link context-set extraction with static shapes (counterpart of
``lpformer_tpu/ops/context.py``), in eval and train mode.

Semantics, as in the JAX package (reference file:line in its docstring):

  * CN / 1-hop candidates are the union of the adjacency rows of src and
    tgt: in both rows -> CN (class 2), in exactly one -> 1-hop (class 1).
  * ppr(src, v) and ppr(tgt, v) are looked up in the sorted PPR rows,
    absent -> 0.0; the self-side values are host-precomputed on the
    adjacency rows.
  * Thresholds: CN kept iff both PPRs >= thresh_cn; 1-hop iff both >=
    thresh_1hop.
  * >1-hop ("all" mode, class 3): src's PPR support with ppr(tgt, v) > 0,
    outside both (unmasked) 1-hop neighbourhoods, both PPRs >=
    thresh_non1hop.
  * Train mode: the batch's positive edges are masked out of both
    adjacency rows in edge-rank space (``mask_ranks``, reference
    train_model.py:38-45), and each candidate is kept with probability
    1 - att_drop (attention dropout as context subsampling, reference
    link_transformer.py:256-260) before the counts.
  * Structure counts are taken before any budget truncation.

Then compaction to static widths, keeping on overflow the entries with
the largest ppr_s + ppr_t, ties toward the earlier entry:

  * classic table (``budget_combined`` None, the JAX package's default):
    each class compacts into its own block, [cn | 1-hop | >1-hop] of
    widths budget_cn, budget_onehop, budget_non1hop (the blocks of the
    active classes only); overflow is the sum of the classes' drops;
  * combined table (``budget_combined``): one compaction of the
    class-disjoint candidate segments into one cross-class budget.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lpformer_tpu_torch.graph.containers import PaddedRows
from lpformer_tpu_torch.ops import masking
from lpformer_tpu_torch.ops.search import (
    row_contains, row_lookup_value, row_member_values,
)


@dataclasses.dataclass(frozen=True)
class ContextConfig:
    mask_mode: str           # "cn" | "1-hop" | "all"
    thresh_cn: float = 0.0
    thresh_1hop: float = 1e-2
    thresh_non1hop: float = 1e-2
    budget_cn: int = 128
    budget_onehop: int = 256
    budget_non1hop: int = 128
    att_drop: float = 0.0
    # one cross-class budget for the class-tagged table; None = the
    # classic per-class blocks of the three budgets above
    budget_combined: Optional[int] = None

    @staticmethod
    def from_thresholds(
        thresh_cn: float, thresh_1hop: float, thresh_non1hop: float, **kw
    ) -> "ContextConfig":
        """Mask mode from the thresholds, as the reference derives it (a
        threshold of 1 excludes that node class)."""
        if thresh_non1hop == 1 and thresh_1hop == 1:
            mode = "cn"
        elif thresh_non1hop == 1 and thresh_1hop < 1:
            mode = "1-hop"
        else:
            mode = "all"
        return ContextConfig(
            mask_mode=mode, thresh_cn=thresh_cn, thresh_1hop=thresh_1hop,
            thresh_non1hop=thresh_non1hop, **kw,
        )

    @property
    def class_budgets(self) -> tuple:
        """The classic table's block widths, active classes only, in the
        order [cn, 1-hop, >1-hop]."""
        return {"cn": (self.budget_cn,),
                "1-hop": (self.budget_cn, self.budget_onehop),
                "all": (self.budget_cn, self.budget_onehop,
                        self.budget_non1hop)}[self.mask_mode]

    @property
    def total_budget(self) -> int:
        if self.budget_combined is not None:
            return self.budget_combined
        return sum(self.class_budgets)

    @property
    def count_dim(self) -> int:
        return {"cn": 1, "1-hop": 3, "all": 4}[self.mask_mode]

    def candidate_columns(self, adj_width: int, ppr_width: int) -> int:
        """A link's candidate columns before compaction, on either table:
        src's adjacency row for the CNs, both endpoints' rows for the
        1-hop class, src's PPR row for the >1-hop class (active classes
        only)."""
        return {"cn": adj_width, "1-hop": 3 * adj_width,
                "all": 3 * adj_width + ppr_width}[self.mask_mode]


@dataclasses.dataclass(frozen=True)
class ContextTables:
    """Compacted per-link context table; the classic layout is
    class-blocked along axis 1 in the order [cn | 1-hop | >1-hop]."""

    ids: torch.Tensor      # [B, C] int32 node ids (pad: num_nodes)
    cls: torch.Tensor      # [B, C] int32: 0 invalid, 1 one-hop, 2 cn, 3 >1hop
    src_ppr: torch.Tensor  # [B, C] float32 ppr(src, v)
    tgt_ppr: torch.Tensor  # [B, C] float32 ppr(tgt, v)
    valid: torch.Tensor    # [B, C] bool
    counts: torch.Tensor   # [B, 4] float32: cns, 1hop, non1hop, neighbours
    overflow: torch.Tensor  # [B] int32 entries dropped by the budget


def _compact(ids, cls, ps, pt, valid, budget: int, num_nodes: int):
    """Compact each row's valid entries, in order, into ``budget`` columns.

    The JAX package compacts through a one-hot ``dot_general`` carrying
    ids+1 in float32 lanes at Precision.HIGHEST; on a GPU a float32
    product under TF32 would corrupt the ids, so here positions are a
    cumsum and the values move with an index scatter (exact for any id).
    On overflow the entries with the largest ps + pt are kept: the row's
    budget-th score is the threshold, entries above it are kept, and ties
    at it are admitted in order (ascending position) while room remains.
    Returns (ids, cls, ps, pt, valid, n_dropped)."""
    b, i = valid.shape
    if i > budget:
        score = torch.where(valid, ps + pt,
                            torch.tensor(float("-inf"), device=ps.device))
        kth = torch.topk(score, budget, dim=1).values[:, -1:]       # [B, 1]
        keep_hi = valid & (score > kth)
        at_thr = valid & (score == kth)
        n_hi = keep_hi.sum(dim=1, keepdim=True)
        room = (budget - n_hi).clamp_min(0)
        thr_rank = torch.cumsum(at_thr.to(torch.int32), dim=1) - 1
        keep = keep_hi | (at_thr & (thr_rank < room))
    else:
        keep = valid
    # kept entries land on columns 0..n_keep-1 in order; the rest write
    # the extra column ``budget``, which is cut off
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    pos = torch.where(keep, pos, torch.full_like(pos, budget))

    def place(vals, fill):
        out = torch.full((b, budget + 1), fill, dtype=vals.dtype,
                         device=vals.device)
        return out.scatter_(1, pos, vals)[:, :budget].contiguous()

    n_keep = keep.sum(dim=1, keepdim=True)
    v2 = torch.arange(budget, device=valid.device)[None, :] < n_keep
    dropped = (valid.sum(dim=1) - budget).clamp_min(0).to(torch.int32)
    return (place(ids, num_nodes), place(cls, 0), place(ps, 0.0),
            place(pt, 0.0), v2, dropped)


@dataclasses.dataclass(frozen=True)
class LinkRows:
    """The adjacency and PPR rows of each node of an endpoint list [B],
    gathered out of the padded row tables. The gather is apart from the
    extraction so that the mesh path can fetch the rows from tables
    row-sharded over its ranks (parallel/sharded_step.py) while one device
    gathers them locally; the extraction (:func:`extract_context_rows`) is
    the same either way.

    adj_nbrs  [B, A] int32  sorted neighbour ids (pad = num_nodes)
    adj_vals  [B, A] f32    self-PPR ppr(u, N(u))
    adj_ranks [B, A] int32  train-edge ranks (-1 = none), or None
    ppr_nbrs  [B, P] int32  sorted PPR support (pad = num_nodes)
    ppr_vals  [B, P] f32    ppr(u, v)
    ppr_flags [B, P] bool   "v is in u's unmasked 1-hop", or None
    """

    adj_nbrs: torch.Tensor
    adj_vals: Optional[torch.Tensor]
    adj_ranks: Optional[torch.Tensor]
    ppr_nbrs: torch.Tensor
    ppr_vals: torch.Tensor
    ppr_flags: Optional[torch.Tensor]


def gather_link_rows(
    adj_rows: PaddedRows,
    ppr_rows: PaddedRows,
    idx: torch.Tensor,
    with_ranks: bool = True,
) -> LinkRows:
    """The rows of the nodes ``idx`` [B], gathered on one device; the
    ranks only ``with_ranks`` (the masked branch reads them)."""
    idx = idx.long()

    def take(t):
        return None if t is None else t[idx]

    return LinkRows(
        adj_nbrs=adj_rows.nbrs[idx], adj_vals=take(adj_rows.vals),
        adj_ranks=take(adj_rows.ranks) if with_ranks else None,
        ppr_nbrs=ppr_rows.nbrs[idx], ppr_vals=ppr_rows.vals[idx],
        ppr_flags=take(ppr_rows.flags))


def extract_context(
    adj_rows: PaddedRows,
    ppr_rows: PaddedRows,
    src: torch.Tensor,
    tgt: torch.Tensor,
    cfg: ContextConfig,
    mask_ranks: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
) -> ContextTables:
    """Context extraction for the links (src[b], tgt[b]): each endpoint's
    rows gathered locally, then :func:`extract_context_rows`.
    ``mask_ranks`` is the batch's masked-rank bitmap
    (``masking.batch_mask_ranks``); with ``train`` and a generator ``gen``
    on the tables' device, the candidates are subsampled at
    ``cfg.att_drop``."""
    masked = mask_ranks is not None
    return extract_context_rows(
        gather_link_rows(adj_rows, ppr_rows, src, with_ranks=masked),
        gather_link_rows(adj_rows, ppr_rows, tgt, with_ranks=masked),
        cfg, adj_rows.num_nodes, mask_ranks=mask_ranks, gen=gen,
        train=train)


def extract_context_rows(
    rows_s: LinkRows,
    rows_t: LinkRows,
    cfg: ContextConfig,
    num_nodes: int,
    mask_ranks: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
) -> ContextTables:
    """Context extraction over each link's gathered rows (the module
    docstring's semantics); ``rows_s`` / ``rows_t`` are the rows of the
    links' sources and targets, with their ranks when ``mask_ranks`` is
    given."""
    n = num_nodes
    all_mode = cfg.mask_mode == "all"
    a_n = rows_s.adj_nbrs               # [B, A] neighbours of src
    b_n = rows_t.adj_nbrs               # [B, A] neighbours of tgt
    p_n = rows_s.ppr_nbrs if all_mode else None   # src's PPR support
    valid_a = a_n < n
    valid_b = b_n < n

    if mask_ranks is None:
        a_in_tgt = row_contains(b_n, a_n)
        b_in_src = row_contains(a_n, b_n)
    else:
        # the rank of edge (src, v) and of edge (tgt, v)
        hit_a = masking.rank_is_masked(mask_ranks, rows_s.adj_ranks)
        hit_b = masking.rank_is_masked(mask_ranks, rows_t.adj_ranks)
        valid_a &= ~hit_a
        valid_b &= ~hit_b
        # membership in the MASKED opposite row: found there, at an entry
        # whose own edge is not masked (the JAX package remaps masked
        # entries to the pad id first; a binary search needs the row
        # sorted, so the hit flag rides along as a looked-up value)
        f_a, (h_a,) = row_member_values(b_n, a_n, (hit_b,))
        f_b, (h_b,) = row_member_values(a_n, b_n, (hit_a,))
        a_in_tgt = f_a & ~h_a
        b_in_src = f_b & ~h_b
    cn_a = valid_a & a_in_tgt                  # CNs, counted on src's row
    onehop_a = valid_a & ~a_in_tgt             # 1-hop via src only
    onehop_b = valid_b & ~b_in_src             # 1-hop via tgt only

    # self-side values ppr(u, N(u)) are host-precomputed on the adjacency
    # rows; only the cross values need a per-batch lookup
    ppr_s_nbrs, ppr_s_vals = rows_s.ppr_nbrs, rows_s.ppr_vals
    ppr_t_nbrs, ppr_t_vals = rows_t.ppr_nbrs, rows_t.ppr_vals
    ps_a = rows_s.adj_vals
    pt_b = rows_t.adj_vals
    pt_a = row_lookup_value(ppr_t_nbrs, ppr_t_vals, a_n)
    ps_b = row_lookup_value(ppr_s_nbrs, ppr_s_vals, b_n)

    thr_cn, thr_1h = cfg.thresh_cn, cfg.thresh_1hop
    cn_a &= (ps_a >= thr_cn) & (pt_a >= thr_cn)
    if cfg.mask_mode != "cn":
        onehop_a &= (ps_a >= thr_1h) & (pt_a >= thr_1h)
        onehop_b &= (ps_b >= thr_1h) & (pt_b >= thr_1h)

    if all_mode:
        # membership in the UNMASKED neighbourhoods on purpose (reference
        # NOTE at link_transformer.py:438-441); "v in N(src)" for src's own
        # support is host-precomputed as the PPR rows' flags
        in_a = rows_s.ppr_flags
        in_b = row_contains(b_n, p_n)
        pt_n = row_lookup_value(ppr_t_nbrs, ppr_t_vals, p_n)
        thr_n1 = cfg.thresh_non1hop
        non1 = ((p_n < n) & (pt_n > 0.0) & ~in_a & ~in_b
                & (ppr_s_vals >= thr_n1) & (pt_n >= thr_n1))

    if train and cfg.att_drop > 0 and gen is not None:
        keep = 1.0 - cfg.att_drop

        def bern(x):
            return torch.rand(x.shape, generator=gen, device=x.device) < keep

        cn_a &= bern(cn_a)
        if cfg.mask_mode != "cn":
            onehop_a &= bern(onehop_a)
            onehop_b &= bern(onehop_b)
        if all_mode:
            non1 &= bern(non1)

    num_cns = cn_a.sum(dim=1).float()
    zeros = torch.zeros_like(num_cns)
    num_1hop = (onehop_a.sum(dim=1) + onehop_b.sum(dim=1)).float() \
        if cfg.mask_mode != "cn" else zeros
    num_non1hop = non1.sum(dim=1).float() if all_mode else zeros
    counts = torch.stack(
        [num_cns, num_1hop, num_non1hop, num_cns + num_1hop], dim=-1)

    if cfg.budget_combined is None:
        # the classic table: each class compacts into its own block
        # (cn from src's row, 1-hop from the src|tgt rows, >1-hop from
        # src's PPR support)
        classes = [((a_n,), (ps_a,), (pt_a,), (cn_a,), 2)]
        if cfg.mask_mode != "cn":
            classes.append(((a_n, b_n), (ps_a, ps_b), (pt_a, pt_b),
                            (onehop_a, onehop_b), 1))
        if all_mode:
            classes.append(((p_n,), (ppr_s_vals,), (pt_n,), (non1,), 3))
        blocks = []
        for (ids, ps, pt, v, code), budget in zip(classes,
                                                  cfg.class_budgets):
            ids = torch.cat(ids, dim=1)
            blocks.append(_compact(
                ids, torch.full_like(ids, code, dtype=torch.int32),
                torch.cat(ps, dim=1), torch.cat(pt, dim=1),
                torch.cat(v, dim=1), budget, n))
        cat = lambda j: torch.cat([blk[j] for blk in blocks], dim=1)  # noqa: E731
        return ContextTables(
            ids=cat(0), cls=cat(1), src_ppr=cat(2), tgt_ppr=cat(3),
            valid=cat(4), counts=counts,
            overflow=sum(blk[5] for blk in blocks),
        )

    # the candidate segments are class-disjoint by construction, so one
    # compaction of their concatenation gives the union of the class sets
    segs = [(a_n, ps_a, pt_a, cn_a, 2)]
    if cfg.mask_mode != "cn":
        segs.append((a_n, ps_a, pt_a, onehop_a, 1))
        segs.append((b_n, ps_b, pt_b, onehop_b, 1))
    if all_mode:
        segs.append((p_n, ppr_s_vals, pt_n, non1, 3))
    cat = lambda j: torch.cat([s[j] for s in segs], dim=1)  # noqa: E731
    cls_all = torch.cat(
        [torch.full_like(s[0], s[4], dtype=torch.int32) for s in segs], dim=1)
    ids2, cls2, ps2, pt2, v2, dropped = _compact(
        cat(0), cls_all, cat(1), cat(2), cat(3), cfg.budget_combined, n)
    return ContextTables(
        ids=ids2, cls=cls2, src_ppr=ps2, tgt_ppr=pt2, valid=v2,
        counts=counts, overflow=dropped,
    )
