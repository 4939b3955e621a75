"""Plain LPFormer (arXiv 2310.11009): context sets, propagation, pairwise
attention with PPR encodings, score head, the training loss, partitioned
clipped Adam and the citation2 evaluation.

``precision`` names the matrix products' input type: "float32" (exact
float32 products, TF32 off), "tfloat32" (inputs rounded to TF32's 10-bit
mantissa, the control one step below float32), "bfloat16" (inputs rounded
to bf16, products summed in f32) or "float8_e4m3fn" (the control one step
below bf16). A bf16 rounding is a cast both ways, so the gradient through it
is rounded too; the TF32 and fp8 roundings are straight-through (the
backward takes the rounded operands, and the gradient is not rounded).

Random draws: a training step draws from one generator on the device, in
this order and these shapes, which the program under test draws alike:
the negatives ``randint(0, N, (2, B))``; the feature dropout [N, F]; each
GCN layer's dropout [N, dim]; then for the positive half and then the
negative half: the context subsampling of the CN, src 1-hop, tgt 1-hop
candidates [B, adj_cap] and of the >1-hop candidates [B, ppr_cap], the
attention output's dropout [B, dim] and the score head's [B, 2 dim].
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.graph import RefGraph

_FP8_MAX = 448.0

# float32 products stay float32 on the card
torch.backends.cuda.matmul.allow_tf32 = False


def _tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits), to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def rounding(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if precision == "tfloat32":
        q = _tf32
    elif precision == "float8_e4m3fn":
        def q(x):
            return x.clamp(-_FP8_MAX, _FP8_MAX).to(
                torch.float8_e4m3fn).float()
    else:
        raise ValueError(f"unknown precision {precision}")

    return lambda x: x + (q(x.detach()) - x.detach())


class Model:
    """The model's functions over one derived graph ``g`` and a
    configuration dict ``cfg`` (dim, dropouts, thresholds, budget)."""

    def __init__(self, cfg: Dict, g: RefGraph, precision: str):
        self.cfg, self.g = cfg, g
        self.q = rounding(precision)
        self.slots = 0              # valid context slots of scored links

    # -- primitives -------------------------------------------------------
    def lin(self, p, x):
        y = self.q(x) @ self.q(p["w"])
        return y + p["b"] if "b" in p else y

    @staticmethod
    def norm(p, x, eps=1e-5):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]

    @staticmethod
    def drop(gen, x, rate):
        if gen is None or rate <= 0:
            return x
        keep = 1.0 - rate
        m = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

    def mlp(self, p, x, gen=None, rate=0.0):
        layers = p["layers"]
        for lp in layers[:-1]:
            x = self.lin(lp, x)
            if "norm" in p:
                x = self.norm(p["norm"], x)
            x = self.drop(gen, torch.relu(x), rate)
        x = self.lin(layers[-1], x)
        return x.squeeze(-1) if x.shape[-1] == 1 else x

    # -- node encoder -----------------------------------------------------
    def propagate(self, P, gen=None):
        c, g = self.cfg, self.g
        x = self.drop(gen, g.x, c["feat_drop"])
        enc = P["node_encoder"]
        for conv, ln in zip(enc["convs"], enc["lns"]):
            h = self.q(x) @ self.q(conv["w"])
            h = torch.sparse.mm(g.a_hat, self.q(h)) + conv["bias"]
            h = torch.relu(self.drop(gen, self.norm(ln, h), c["gnn_drop"]))
            x = x + h if c["residual"] and x.shape[-1] == h.shape[-1] else h
        return self.norm(P["gnn_norm"], x)

    # -- context sets -----------------------------------------------------
    @staticmethod
    def _member(rows, q):
        pos = torch.searchsorted(rows, q).clamp(max=rows.shape[1] - 1)
        return rows.gather(1, pos) == q, pos

    def _value(self, rows, vals, q):
        found, pos = self._member(rows, q)
        return torch.where(found, vals.gather(1, pos), torch.zeros_like(
            vals[:, :1]))

    def masked_entries(self, owner, nbrs, batch_keys):
        """Adjacency entries (owner, nbr) whose undirected edge the batch
        holds as many times as the train split does."""
        g = self.g
        k = g.canonical(owner.expand_as(nbrs), nbrs)
        pos = torch.searchsorted(batch_keys[0], k).clamp(
            max=max(len(batch_keys[0]) - 1, 0))
        found = batch_keys[0][pos] == k
        tpos = torch.searchsorted(g.train_keys, k).clamp(
            max=len(g.train_keys) - 1)
        tfound = g.train_keys[tpos] == k
        return (found & tfound & (nbrs < g.n)
                & (batch_keys[1][pos] >= g.train_mult[tpos]))

    def context(self, src, tgt, batch_keys=None, gen=None):
        """The combined context table of each link: (ids, cls, ps, pt,
        valid [B, budget], counts [B, 4])."""
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
        ps_rows, ps_vals = g.ppr_nbrs[src], g.ppr_vals[src]
        pt_rows, pt_vals = g.ppr_nbrs[tgt], g.ppr_vals[tgt]
        pt_a = self._value(pt_rows, pt_vals, a)
        ps_b = self._value(ps_rows, ps_vals, b)
        t_cn, t_1, t_n = c["thresh_cn"], c["thresh_1hop"], c["thresh_non1hop"]
        cn = va & a_in_b & (pa >= t_cn) & (pt_a >= t_cn)
        one_a = va & ~a_in_b & (pa >= t_1) & (pt_a >= t_1)
        one_b = vb & ~b_in_a & (ps_b >= t_1) & (pb >= t_1)
        in_b, _ = self._member(b, ps_rows)
        pt_n = self._value(pt_rows, pt_vals, ps_rows)
        non1 = ((ps_rows < n) & (pt_n > 0) & ~g.ppr_flags[src] & ~in_b
                & (ps_vals >= t_n) & (pt_n >= t_n))
        if gen is not None and c["att_drop"] > 0:
            keep = 1.0 - c["att_drop"]
            cn, one_a, one_b, non1 = (
                m & (torch.rand(m.shape, generator=gen, device=m.device)
                     < keep)
                for m in (cn, one_a, one_b, non1))
        n_cn = cn.sum(1).float()
        n_1 = (one_a.sum(1) + one_b.sum(1)).float()
        counts = torch.stack([n_cn, n_1, non1.sum(1).float(), n_cn + n_1], -1)
        # one table of every candidate; on overflow the largest ps + pt,
        # ties to the earlier candidate
        ids = torch.cat([a, a, b, ps_rows], 1)
        ps = torch.cat([pa, pa, ps_b, ps_vals], 1)
        pt = torch.cat([pt_a, pt_a, pb, pt_n], 1)
        valid = torch.cat([cn, one_a, one_b, non1], 1)
        cls = torch.cat([torch.full_like(a, 2), torch.full_like(a, 1),
                         torch.full_like(b, 1),
                         torch.full_like(ps_rows, 3)], 1)
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

    # -- links ------------------------------------------------------------
    def pairwise(self, P, X, src, tgt, ctx, gen=None):
        c = self.cfg
        ids, cls, ps, pt, valid, counts = ctx
        lp = P["att_layers"][0]
        d = c["dim"]
        q_ = self.lin(lp["lin_l"], X[src]) + self.lin(lp["lin_l"], X[tgt])
        pe = 0.0
        for code, name in ((2, "ppr_encoder_cn"), (1, "ppr_encoder_onehop"),
                           (3, "ppr_encoder_non1hop")):
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
        out = (alpha[..., None] * xj).sum(1) + lp["bias"]
        out = self.drop(gen, self.norm(lp["post_norm"], out), c["dropout"])
        return self.mlp(P["pairwise_lin"], torch.cat([out, counts], -1))

    def score(self, P, X, src, tgt, batch_keys=None, gen=None):
        elem = self.mlp(P["elementwise_lin"], X[src] * X[tgt])
        ctx = self.context(src, tgt, batch_keys, gen)
        self.slots = self.slots + ctx[4].sum()
        h = torch.cat([elem, self.pairwise(P, X, src, tgt, ctx, gen)], -1)
        return torch.sigmoid(self.mlp(P["score"], h, gen,
                                      self.cfg["pred_drop"]))

    # -- training ---------------------------------------------------------
    def batch_keys(self, src, tgt, w):
        k = self.g.canonical(src, tgt)[w > 0]
        return torch.unique(k, return_counts=True)

    def loss(self, P, src, tgt, w, gen):
        b = src.shape[0]
        neg = torch.randint(0, self.g.n, (2, b), generator=gen,
                            device=src.device, dtype=src.dtype)
        X = self.propagate(P, gen)
        pos = self.score(P, X, src, tgt, self.batch_keys(src, tgt, w), gen)
        negs = self.score(P, X, neg[0], neg[1], None, gen)
        ws = w.sum().clamp_min(1.0)
        return (-(torch.log(pos + 1e-6) * w).sum() / ws
                - (torch.log(1.0 - negs + 1e-6) * w).sum() / ws)


class Adam:
    """torch Adam (no weight decay) with the gradient clipped to norm 1
    twice: over the score head's leaves and over all the others."""

    def __init__(self, leaves: List, lr: float, clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.leaves = leaves          # (path, tensor) pairs
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.m = [torch.zeros_like(x) for _, x in leaves]
        self.v = [torch.zeros_like(x) for _, x in leaves]
        self.count = 0

    def clipped(self) -> List[torch.Tensor]:
        gs = [x.grad if x.grad is not None else torch.zeros_like(x)
              for _, x in self.leaves]
        head = [p[0] == "score" for p, _ in self.leaves]
        out = list(gs)
        for part in (True, False):
            idx = [i for i, h in enumerate(head) if h == part]
            nrm = torch.sqrt(sum((gs[i] * gs[i]).sum() for i in idx))
            scale = (self.clip / nrm.clamp_min(1e-12)).clamp_max(1.0)
            for i in idx:
                out[i] = gs[i] * scale
        return out

    @torch.no_grad()
    def step(self) -> List[torch.Tensor]:
        """One update; returns the clipped gradient it took."""
        gs = self.clipped()
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for i, ((_, x), g) in enumerate(zip(self.leaves, gs)):
            self.m[i].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.v[i].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            x.sub_(self.lr * (self.m[i] / c1)
                   / ((self.v[i] / c2).sqrt() + self.eps))
            x.grad = None
        return gs


def train_steps(model: Model, P: Dict, batches, lr: float, gen_seed: int,
                device) -> Dict:
    """Training steps from the weights ``P`` (updated in place) on the
    [src, tgt, w] ``batches``: each step's loss, the first step's clipped
    gradient per leaf and each leaf's change over all the steps."""
    from reference.params import leaves
    pairs = leaves(P)
    start = [x.detach().clone() for _, x in pairs]
    opt = Adam(pairs, lr)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    losses, grad1 = [], None
    for src, tgt, w in batches:
        loss = model.loss(P, src, tgt, w, gen)
        loss.backward()
        gs = opt.step()
        if grad1 is None:
            grad1 = [g.clone() for g in gs]
        losses.append(loss.item())
    return {"paths": [p for p, _ in pairs], "losses": losses,
            "grad1": grad1,
            "delta": [x.detach() - s for (_, x), s in zip(pairs, start)]}


@torch.no_grad()
def citation2_scores(model: Model, P: Dict, pos: torch.Tensor,
                     neg_tgt: torch.Tensor, batch: int) -> Dict:
    """Eval-mode scores of the positives [P, 2] and of each positive's
    source against its negative targets [P, K]."""
    X = model.propagate(P)

    def sc(src, tgt):
        return torch.cat([model.score(P, X, src[i:i + batch], tgt[i:i + batch])
                          for i in range(0, len(src), batch)])

    k = neg_tgt.shape[1]
    ps = sc(pos[:, 0], pos[:, 1])
    ns = sc(pos[:, 0].repeat_interleave(k), neg_tgt.reshape(-1)).reshape(-1, k)
    return {"pos": ps, "neg": ns}


def mrr(pos, neg) -> float:
    """OGB's MRR of the positives' scores [P] against their negatives'
    [P, K], in float64: rank = 1 + half the ties + the negatives above."""
    pos = torch.as_tensor(pos).double()
    neg = torch.as_tensor(neg).double()
    rank = 1.0 + 0.5 * ((neg >= pos[:, None]).sum(1)
                        + (neg > pos[:, None]).sum(1))
    return float((1.0 / rank).mean())
