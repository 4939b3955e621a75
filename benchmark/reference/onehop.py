"""Plain LPFormer in its ``1-hop`` mode (thresh_non1hop 1, thresh_1hop
under 1), the mode of its published ogbl-ddi run: a link (a, b) attends
over its common neighbours (class 2) and the neighbours of one endpoint
alone (class 1), with no >1-hop class. Everything else, and the weights'
tree less its >1-hop encoder (``reference/params_onehop.py``), is
``reference/model.py``'s.

  * candidates: a's adjacency row for the CNs, then a's row and b's row
    for the 1-hop nodes, in one table ``[a, a, b]``;
  * random draws: the context subsampling of the CN, src 1-hop and tgt
    1-hop candidates [B, adj_cap] each, in that order (no >1-hop draw);
  * structure counts [cn, 1-hop, cn + 1-hop], so ``pairwise_lin`` takes
    dim + 3;
  * encoders ``ppr_encoder_cn`` (class 2) and ``ppr_encoder_onehop``
    (class 1).

Departures from the published description (arXiv 2310.11009 and its
code's ``link_transformer.py``), besides ``reference/model.py``'s:

  * the third count is the CNs plus the 1-hop nodes that pass
    thresh_1hop; the published code counts there the CNs plus the 1-hop
    nodes with any PPR above 0 (its "num_neighbors", :154-155, :170-175);
  * one table of ``budget_combined`` slots, kept by the largest ps + pt
    on overflow; the published code takes every candidate (the
    configurations size the budget so that no pair overflows it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import model as ref_model
from reference.model import (  # noqa: F401
    Adam, citation2_scores, mrr, rounding, train_steps,
)

ENCODERS = ((2, "ppr_encoder_cn"), (1, "ppr_encoder_onehop"))

# float32 products stay float32 on the card (reference.model sets matmul's)
torch.backends.cudnn.allow_tf32 = False


class Model(ref_model.Model):
    """``reference.model.Model`` with the ``1-hop`` mode's context table
    and encoders."""

    def context(self, src, tgt, batch_keys=None, gen=None):
        """The combined context table of each link: (ids, cls, ps, pt,
        valid [B, budget], counts [B, 3])."""
        c, g = self.cfg, self.g
        n = g.n
        if not (g.have[src].all() and g.have[tgt].all()):
            raise ValueError("a link's endpoint has no PPR row")
        a, pa = g.adj_nbrs[src], g.adj_vals[src]
        b, pb = g.adj_nbrs[tgt], g.adj_vals[tgt]
        va, vb = a < n, b < n
        if batch_keys is None:
            a_in_b, _ = self._member(b, a)
            b_in_a, _ = self._member(a, b)
        else:
            hit_a = self.masked_entries(src[:, None], a, batch_keys)
            hit_b = self.masked_entries(tgt[:, None], b, batch_keys)
            va, vb = va & ~hit_a, vb & ~hit_b
            fa, pos_a = self._member(b, a)
            fb, pos_b = self._member(a, b)
            a_in_b = fa & ~hit_b.gather(1, pos_a)
            b_in_a = fb & ~hit_a.gather(1, pos_b)
        pt_a = self._value(g.ppr_nbrs[tgt], g.ppr_vals[tgt], a)
        ps_b = self._value(g.ppr_nbrs[src], g.ppr_vals[src], b)
        t_cn, t_1 = c["thresh_cn"], c["thresh_1hop"]
        cn = va & a_in_b & (pa >= t_cn) & (pt_a >= t_cn)
        one_a = va & ~a_in_b & (pa >= t_1) & (pt_a >= t_1)
        one_b = vb & ~b_in_a & (ps_b >= t_1) & (pb >= t_1)
        if gen is not None and c["att_drop"] > 0:
            keep = 1.0 - c["att_drop"]
            cn, one_a, one_b = (
                m & (torch.rand(m.shape, generator=gen, device=m.device)
                     < keep)
                for m in (cn, one_a, one_b))
        n_cn = cn.sum(1).float()
        n_1 = (one_a.sum(1) + one_b.sum(1)).float()
        counts = torch.stack([n_cn, n_1, n_cn + n_1], -1)
        # one table of every candidate; on overflow the largest ps + pt,
        # ties to the earlier candidate
        ids = torch.cat([a, a, b], 1)
        ps = torch.cat([pa, pa, ps_b], 1)
        pt = torch.cat([pt_a, pt_a, pb], 1)
        valid = torch.cat([cn, one_a, one_b], 1)
        cls = torch.cat([torch.full_like(a, 2), torch.full_like(a, 1),
                         torch.full_like(b, 1)], 1)
        budget = c["budget_combined"]
        score = torch.where(valid, ps + pt, torch.full_like(ps, -math.inf))
        kth = torch.topk(score, budget, dim=1).values[:, -1:]
        above = valid & (score > kth)
        tie = valid & (score == kth)
        room = budget - above.sum(1, keepdim=True)
        keep = above | (tie & (torch.cumsum(tie.int(), 1) <= room))
        order = torch.sort((~keep).int(), dim=1,
                           stable=True).indices[:, :budget]
        kept = keep.gather(1, order)
        take = lambda t: t.gather(1, order)  # noqa: E731
        return (torch.where(kept, take(ids), 0), take(cls), take(ps),
                take(pt), kept, counts)

    def attend(self, P, X, q_, ids, cls, ps, pt, valid):
        """``reference.model.Model.attend`` over the two classes'
        encoders."""
        lp = P["att_layers"][0]
        d = self.cfg["dim"]
        pe = 0.0
        for code, name in ENCODERS:
            enc = P[name]
            e = (self.mlp(enc, torch.stack([ps, pt], -1))
                 + self.mlp(enc, torch.stack([pt, ps], -1)))
            pe = pe + e * (cls == code)[..., None]
        w_r = lp["lin_r"]["w"]
        xj = (self.q(X[ids]) @ self.q(w_r[:d]) + self.q(pe) @ self.q(w_r[d:])
              + lp["lin_r"]["b"])
        z = F.leaky_relu(xj * q_[:, None, :], 0.2)
        logits = (z * lp["att"][0]).sum(-1)
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
        m = logits.amax(1, keepdim=True).clamp_min(-5e29)
        e = torch.exp(logits - m) * valid
        alpha = e / e.sum(1, keepdim=True).clamp_min(1e-16)
        return (alpha[..., None] * xj).sum(1)
