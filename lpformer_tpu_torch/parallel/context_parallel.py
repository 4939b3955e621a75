"""Context-parallel per-link attention: the context axis sharded over the
'graph' mesh axis with a merged two-pass softmax (counterpart of
``lpformer_tpu/parallel/context_parallel.py``).

A link's context set, its "sequence", is split over the ranks of the
graph axis; each rank computes flash-style partial softmax statistics
over its slice of C (max, denominator, weighted sum), and the exact
global softmax comes back from a pmax and two psums:
  m = max_k m_k;  l = sum_k l_k e^{m_k - m};  acc = sum_k acc_k e^{m_k - m}.
No [B, C, H*O] key table exists on one rank. The rows are the dense
attention route's (``models/link_transformer.py``: ``_project_keys``), on
the slice: the node keys are gathered from the projected node table, so
the gather's backward is the scatter-add (ops/scatter.py, a kernel on the
card), and the softmax is plain torch, as the JAX package's is XLA.

Slices are per class block (the classic table's CN / 1-hop / >1-hop
blocks keep their PE encoders), so every class budget must divide by the
axis size; on the combined table the one block is sliced and each slot's
class picks its encoder.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.nn import core as nn
from lpformer_tpu_torch.ops.context import ContextTables
from lpformer_tpu_torch.ops.gather import gather_rows
from lpformer_tpu_torch.parallel import collectives as col

_NEG = -1e30


def _class_blocks(cfg: LPFormerConfig):
    """(offset, size, encoder name) per active node class; the combined
    table is ONE mixed block whose encoder is chosen per slot (None)."""
    c = cfg.context
    if c.budget_combined is not None:
        return [(0, c.budget_combined, None)]
    blocks = [(0, c.budget_cn, "ppr_encoder_cn")]
    ofs = c.budget_cn
    if cfg.mask_mode != "cn":
        blocks.append((ofs, c.budget_onehop, "ppr_encoder_onehop"))
        ofs += c.budget_onehop
    if cfg.mask_mode == "all":
        blocks.append((ofs, c.budget_non1hop, "ppr_encoder_non1hop"))
    return blocks


def check_cp_budgets(cfg: LPFormerConfig, g: int) -> None:
    for _, size, name in _class_blocks(cfg):
        if size % g != 0:
            raise ValueError(
                f"context-parallel axis size {g} must divide every class "
                f"budget; {name or 'combined'} block has budget {size}")


def _slice_blocks(arr: torch.Tensor, cfg: LPFormerConfig, g: int,
                  k: int) -> torch.Tensor:
    """Rank k's slice of each class block, concatenated: [B, C/g, ...]."""
    parts = []
    for ofs, size, _ in _class_blocks(cfg):
        s = size // g
        parts.append(arr[:, ofs + k * s:ofs + (k + 1) * s])
    return torch.cat(parts, dim=1)


def _slice_cfg(cfg: LPFormerConfig, g: int) -> LPFormerConfig:
    """The config of one slice: every class budget divided by g."""
    return dataclasses.replace(
        cfg, budget_cn=cfg.budget_cn // g,
        budget_onehop=cfg.budget_onehop // g,
        budget_non1hop=cfg.budget_non1hop // g,
        budget_combined=(None if cfg.budget_combined is None
                         else cfg.budget_combined // g))


def _slice_ctx(ctx: ContextTables, cfg: LPFormerConfig, g: int,
               k: int) -> ContextTables:
    def sl(a):
        return _slice_blocks(a, cfg, g, k)

    return dataclasses.replace(ctx, ids=sl(ctx.ids), cls=sl(ctx.cls),
                               src_ppr=sl(ctx.src_ppr),
                               tgt_ppr=sl(ctx.tgt_ppr), valid=sl(ctx.valid))


def _pos_encodings_sliced(
    params: Dict, cfg: LPFormerConfig, ctx: ContextTables, g: int, k: int,
    W_fold: Optional[torch.Tensor] = None, out_dtype=None,
) -> torch.Tensor:
    """Rank k's symmetrised PPR encodings [B, C/g, ...]: each slice lies
    inside one class block, so the classic table's per-class encoder is
    known; on the combined table each slot's class selects."""
    return lt._pos_encodings(params, _slice_cfg(cfg, g),
                             _slice_ctx(ctx, cfg, g, k), W_fold, out_dtype)


def _att_layer_cp(
    lp: Dict, cfg: LPFormerConfig, edge_x: torch.Tensor, xj: torch.Tensor,
    valid: torch.Tensor, group, gen: Optional[torch.Generator] = None,
    train: bool = False,
) -> torch.Tensor:
    """One GATv2-style attention layer (reference layers.py:193-224) over
    this rank's keys xj [B, Cg, H*O]; the softmax spans the group's slices.
    ``edge_x`` and ``gen`` are the same on every rank of the group."""
    h = cfg.num_heads
    b_, cg_, _ = xj.shape
    half = edge_x.shape[-1] // 2
    o = lp["lin_l"]["w"].shape[1] // h
    e1 = nn.linear_apply(lp["lin_l"], edge_x[:, :half], cfg.mm_dtype)
    e2 = nn.linear_apply(lp["lin_l"], edge_x[:, half:], cfg.mm_dtype)
    xj = xj.reshape(b_, cg_, h, o)
    z = F.leaky_relu(xj * (e1.reshape(b_, 1, h, o) + e2.reshape(b_, 1, h, o)),
                     negative_slope=0.2)
    logits = (z * lp["att"]).sum(-1)                         # [B, Cg, H]
    v = valid[:, :, None]
    logits = torch.where(v, logits, torch.full_like(logits, _NEG))
    # the shift m cancels out of the softmax, so a detached pmax is exact
    m = col.pmax(logits.amax(dim=1, keepdim=True), group).clamp_min(_NEG / 2)
    e = torch.exp(logits - m) * v.to(logits.dtype)           # [B, Cg, H]
    l_ = col.psum(e.sum(dim=1, keepdim=True), group)         # [B, 1, H]
    acc = col.psum((e[..., None] * xj).sum(dim=1), group)    # [B, H, O]
    out = acc / l_.reshape(b_, h, 1).clamp_min(1e-16)
    out = out.reshape(b_, h * o) + lp["bias"]
    out = nn.layer_norm_apply(lp["post_norm"], out)
    return nn.dropout(gen, out, cfg.dropout, train)


def cp_calc_pairwise(
    params: Dict, cfg: LPFormerConfig, X_full: torch.Tensor,
    src: torch.Tensor, tgt: torch.Tensor, ctx: ContextTables, mesh, *,
    gen: Optional[torch.Generator] = None, train: bool = False,
) -> torch.Tensor:
    """The pairwise term [B, dim] with the context axis sharded over the
    mesh's graph axis (``calc_pairwise``'s counterpart; reference
    link_transformer.py:132-178). ``ctx`` holds the WHOLE [B, C] tables,
    the same on every rank of the axis (ids and PPR scalars, cheap); only
    the wide tensors (keys, PE, attention transients) are sliced. ``gen``
    is the same along the axis too. ``params`` as calc_pairwise takes
    them (matmul weights cast)."""
    g, k = mesh.graph, mesh.graph_index
    cfg_s = _slice_cfg(cfg, g)
    ctx_s = _slice_ctx(ctx, cfg, g, k)
    feats = torch.cat([gather_rows(X_full, src), gather_rows(X_full, tgt)],
                      dim=-1)
    for lp in params["att_layers"]:
        xj = lt._project_keys(lp, params, cfg_s, X_full, ctx_s)
        feats = _att_layer_cp(lp, cfg, feats, xj, ctx_s.valid,
                              mesh.graph_group, gen, train)
    counts = ctx.counts
    if cfg.mask_mode == "cn":
        cnt = counts[:, 0:1]
    elif cfg.mask_mode == "1-hop":
        cnt = torch.cat([counts[:, 0:1], counts[:, 1:2], counts[:, 3:4]],
                        dim=-1)
    else:
        cnt = counts
    feats = torch.cat([feats, cnt], dim=-1)
    return nn.mlp_apply(params["pairwise_lin"], feats, mm_dtype=cfg.mm_dtype)
