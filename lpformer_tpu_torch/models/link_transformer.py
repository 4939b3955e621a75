"""LPFormer for link prediction (counterpart of
``lpformer_tpu/models/link_transformer.py``), eval and train paths.

  h(a, b) = [ MLP(x_a * x_b)  ||  pairwise(a, b) ]               (:82-107)
  pairwise = MLP( attention over a's and b's context nodes || counts )

The attention is GATv2-style over each link's context set, with
symmetrised PPR positional encodings per node class (reference:
src/models/link_transformer.py:132-211, src/modules/layers.py:193-224).
It takes one of two routes, as the JAX package's does:

  * the fused op, ONE op over the context table that computes the PE
    MLPs, the key projection and the masked attention: a hand-written
    CUDA kernel on a CUDA tensor and its plain torch version on a CPU
    tensor (the counterparts of the JAX package's Pallas kernels). It
    takes the node half of the keys by id (``KeyRows``: X_node @ W_r[:d]
    and the context ids), and its kernels read each valid slot's row in
    place, so no [B, C, O] key table is written. The classic class-blocked
    table (``budget_combined=None``, the default)
    runs ``ops/pe_attention.py`` with the blocks' widths; the combined
    class-tagged table ``ops/pe_attention_mixed.py`` with a per-slot
    encoder index;
  * the dense masked route (``_project_keys`` + ``_att_layer_apply``,
    the JAX package's non-Pallas path, XLA there and plain torch here):
    the [B, C, H*O] key table is materialised and H heads attend over it.

The route is chosen by one rule and nothing else: the fused op when
``cfg.use_pallas_attention`` is not False, ``cfg.num_heads == 1`` and no
attention weights are asked for (``return_weights``); the dense route
otherwise. No caught exception, failed build or device check sends a call
to the dense route.

Parameters are the JAX package's pytree as nested dicts of tensors
(``utils/params.py``).

Training (``train=True``) adds the reference's dropouts, drawn in a fixed
order from one ``torch.Generator`` on the model's device: feat_drop on the
input features, gnn_drop in every GCN layer, att_drop as context
subsampling, dropout after each attention layer's post-LayerNorm and
pred_drop in the score head; and the batch's positive edges are masked out
of the context adjacency (``mask_ranks``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.graph.containers import GraphBundle
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.models.gcn import gcn_apply, gcn_init
from lpformer_tpu_torch.nn import core as nn
from lpformer_tpu_torch.ops.context import ContextTables, extract_context
from lpformer_tpu_torch.ops.gather import gather_rows, gather_rows_valid
from lpformer_tpu_torch.ops.pe_attention import fused_pe_link_attention
from lpformer_tpu_torch.ops.pe_attention_mixed import (
    KeyRows, fused_pe_link_attention_mixed,
)
from lpformer_tpu_torch.ops.segment import masked_softmax
from lpformer_tpu_torch.utils import profiling


def _att_layer_init(gen, in_ch, out_ch, heads, node_dim, device) -> Dict:
    """One LinkTransformerLayer: GATv2-style attention + post LayerNorm
    (reference: src/modules/layers.py:88-157)."""
    lin_l = nn.linear_init(gen, in_ch, heads * out_ch, kind="glorot",
                           device=device)
    lin_r = nn.linear_init(gen, node_dim * 2, heads * out_ch, kind="glorot",
                           device=device)
    bound = (6.0 / (heads + out_ch)) ** 0.5  # PyG glorot on att [1, H, C]
    att = nn.uniform_init(gen, (heads, out_ch), bound, device)
    return {
        "lin_l": lin_l,
        "lin_r": lin_r,
        "att": att,
        "bias": torch.zeros(heads * out_ch, dtype=torch.float32, device=device),
        "post_norm": nn.layer_norm_init(heads * out_ch, device),
    }


def init_lpformer(
    gen: torch.Generator, cfg: LPFormerConfig, in_dim: int, device=None
) -> Dict:
    """Random parameters with the JAX package's shapes and init
    distributions, drawn from ``gen`` (a CPU generator)."""
    if cfg.trans_layers > 2 or (cfg.trans_layers == 2 and cfg.num_heads != 1):
        raise NotImplementedError(
            "trans_layers > 2, and trans_layers == 2 with num_heads > 1, "
            "are unsupported (as in the JAX package)")
    dev = resolve_device(device)
    d = cfg.dim
    p: Dict = {}
    p["node_encoder"] = gcn_init(gen, in_dim, d, d, cfg.gnn_layers,
                                 cfg.layer_norm, device=dev)
    p["gnn_norm"] = nn.layer_norm_init(d, dev)
    p["elementwise_lin"] = nn.mlp_init(gen, 2, d, d, d, device=dev)
    for name, _ in _encoder_codes(cfg):
        p[name] = nn.mlp_init(gen, 2, 2, d, d, device=dev)
    inner = d * 2 if cfg.trans_layers > 1 else d
    p["att_layers"] = [_att_layer_init(gen, d, inner, cfg.num_heads, d, dev)]
    if cfg.trans_layers == 2:
        p["att_layers"].append(
            _att_layer_init(gen, d, d, cfg.num_heads, d, dev))
    pairwise_dim = d * cfg.num_heads + cfg.count_dim
    p["pairwise_lin"] = nn.mlp_init(gen, 2, pairwise_dim, pairwise_dim, d,
                                    device=dev)
    # score head: mlp_score(out_dim, out_dim, 1, pred_layers)
    p["score"] = nn.mlp_init(gen, cfg.pred_layers, cfg.out_dim, cfg.out_dim,
                             1, norm="none", device=dev)
    return p


def propagate(params: Dict, cfg: LPFormerConfig, graph: GraphBundle, *,
              gen: Optional[torch.Generator] = None,
              train: bool = False,
              edge_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GNN node encoding + final LayerNorm -> X_node [N, dim]
    (reference: link_transformer.py:110-129, node_encoder.py:35-44).
    ``edge_w`` [E] replaces the bundle's propagation weights (the
    batch-masked weights of ``mask_input``); the host-precomputed norm
    holds for the bundle's own weights only, so with ``edge_w`` the GCN
    recomputes it on the device."""
    with profiling.span("model.propagate"):
        params = nn.cast_matmul_weights(params, cfg.mm_dtype)
        x = nn.dropout(gen, graph.x, cfg.feat_drop, train)
        x = gcn_apply(
            params["node_encoder"], x, graph.edge_src, graph.edge_dst,
            graph.edge_w if edge_w is None else edge_w, graph.num_nodes,
            gnn_drop=cfg.gnn_drop, residual=cfg.residual, relu=cfg.relu,
            gen=gen, train=train, mm_dtype=cfg.mm_dtype, ell=graph.ell,
            norm=(graph.w_norm, graph.w_diag) if edge_w is None else None,
            blk=graph.blk, bbell=graph.bbell,
        )
        return nn.layer_norm_apply(params["gnn_norm"], x)


def _encoder_codes(cfg: LPFormerConfig):
    """Active (encoder name, context class code) pairs in the canonical
    [cn(2), 1-hop(1), >1-hop(3)] order (codes: ops/context.ContextTables)."""
    pairs = [("ppr_encoder_cn", 2)]
    if cfg.mask_mode != "cn":
        pairs.append(("ppr_encoder_onehop", 1))
    if cfg.mask_mode == "all":
        pairs.append(("ppr_encoder_non1hop", 3))
    return pairs


def _att_layer_apply_fused(
    lp: Dict, params: Dict, cfg: LPFormerConfig, edge_x: torch.Tensor,
    xj_node: KeyRows, ctx: ContextTables,
    gen: Optional[torch.Generator] = None, train: bool = False,
) -> torch.Tensor:
    """One attention layer through the fused PE + attention op, the node
    half of its keys by id (``_node_key_rows``). The PE
    MLPs' last linear is folded into W_r's PE half here (w2f = W2 @
    W_r[d:], cbias = 2 b2 @ W_r[d:] + b_r), in plain torch, so the op's
    stacked-weight grads flow back to the true parameter leaves and its PE
    lands directly in the projected key space. The classic table passes
    its class blocks' widths; on the combined table ``ecls`` maps the
    context class codes to encoder indices 0..K-1. Post-LayerNorm, then
    dropout (reference layers.py:78-80)."""
    half = edge_x.shape[-1] // 2
    e1 = nn.linear_apply(lp["lin_l"], edge_x[:, :half], cfg.mm_dtype)
    e2 = nn.linear_apply(lp["lin_l"], edge_x[:, half:], cfg.mm_dtype)

    d = cfg.dim
    w_fold = lp["lin_r"]["w"][d:].float()                    # [dim, O]
    r_bias = lp["lin_r"].get("b")
    if r_bias is None:
        r_bias = torch.zeros(w_fold.shape[1], device=w_fold.device)
    w1, b1, g_ln, b_ln, w2f, cbias = [], [], [], [], [], []
    for name, _ in _encoder_codes(cfg):
        mp = params[name]
        l1, l2 = mp["layers"]
        w1.append(l1["w"].float())
        b1.append(l1["b"].float())
        g_ln.append(mp["norm"]["g"].float())
        b_ln.append(mp["norm"]["b"].float())
        w2f.append(l2["w"].float() @ w_fold)
        cbias.append(2.0 * (l2["b"].float() @ w_fold) + r_bias)
    weights = (torch.stack(w1), torch.stack(b1), torch.stack(g_ln),
               torch.stack(b_ln), torch.stack(w2f).to(xj_node.dtype),
               torch.stack(cbias), lp["att"], lp["bias"])
    if cfg.budget_combined is None:
        with profiling.span("model.pe_attention"):
            out, _, _ = fused_pe_link_attention(
                xj_node, ctx.src_ppr, ctx.tgt_ppr, ctx.valid, e1 + e2,
                *weights, class_widths=cfg.context.class_budgets)
    else:
        ecls = torch.zeros_like(ctx.cls)
        for k, (_, code) in enumerate(_encoder_codes(cfg)):
            ecls = torch.where(ctx.cls == code, k, ecls)
        with profiling.span("model.pe_attention"):
            out, _, _ = fused_pe_link_attention_mixed(
                xj_node, ctx.src_ppr, ctx.tgt_ppr, ctx.valid, ecls, e1 + e2,
                *weights)
    out = nn.layer_norm_apply(lp["post_norm"], out)
    return nn.dropout(gen, out, cfg.dropout, train)


def _fold_last(mlp_p: Dict, W: torch.Tensor) -> Dict:
    """Compose an MLP's final (bare) linear with a following linear ``W``,
    so ``mlp(x) @ W`` runs as one MLP whose output lands directly in the
    projected space: the [B, C, dim] intermediate never exists. The
    products keep the JAX dtype flow: ``w @ W`` in the operands' promoted
    dtype (bf16 @ bf16 -> bf16 under matmul_dtype, summed in f32), and
    ``b @ W`` in f32 (an f32 bias promotes)."""
    layers = list(mlp_p["layers"])
    w = layers[-1]["w"]
    last = {"w": (w.float() @ W.float()).to(
        torch.promote_types(w.dtype, W.dtype))}
    if "b" in layers[-1]:
        b = layers[-1]["b"]
        last["b"] = (b.float() @ W.float()).to(
            torch.promote_types(b.dtype, W.dtype))
    layers[-1] = last
    return dict(mlp_p, layers=layers)


def _pos_encodings(
    params: Dict, cfg: LPFormerConfig, ctx: ContextTables,
    W_fold: Optional[torch.Tensor] = None, out_dtype=None,
) -> torch.Tensor:
    """Symmetric PPR encodings pe = g(ppr_s, ppr_t) + g(ppr_t, ppr_s), one
    MLP per node class (reference: link_transformer.py:182-211). With
    ``W_fold`` the result is pe @ W_fold, computed by folding W_fold into
    each class MLP's final linear; ``out_dtype`` casts each block at
    creation (bf16 key tables under ``matmul_dtype``). On the classic
    table each class MLP runs over its own block of the table; on the
    combined table every class MLP runs over the whole [B, C] table and
    each slot's class selects."""
    def sym(mlp_p, ps, pt):
        if W_fold is not None:
            mlp_p = _fold_last(mlp_p, W_fold)
        a = nn.mlp_apply(mlp_p, torch.stack([ps, pt], dim=-1),
                         mm_dtype=cfg.mm_dtype)
        b = nn.mlp_apply(mlp_p, torch.stack([pt, ps], dim=-1),
                         mm_dtype=cfg.mm_dtype)
        out = a + b
        return out if out_dtype is None else out.to(out_dtype)

    ps, pt = ctx.src_ppr, ctx.tgt_ppr
    if cfg.budget_combined is not None:
        out = None
        for name, code in _encoder_codes(cfg):
            pe = sym(params[name], ps, pt)
            m = (ctx.cls == code).to(pe.dtype)[..., None]
            out = pe * m if out is None else out + pe * m
        return out
    blocks, ofs = [], 0
    codes = _encoder_codes(cfg)
    for k, ((name, _), width) in enumerate(
            zip(codes, cfg.context.class_budgets)):
        hi = ps.shape[1] if k == len(codes) - 1 else ofs + width
        blocks.append(sym(params[name], ps[:, ofs:hi], pt[:, ofs:hi]))
        ofs = hi
    return torch.cat(blocks, dim=1)


def _project_nodes(lp: Dict, cfg: LPFormerConfig,
                   X_node: torch.Tensor) -> torch.Tensor:
    """X_node @ W_r[:dim] [N, H*O], once in [N] space (N << B*C), in the
    key dtype (bf16 under matmul_dtype)."""
    d = X_node.shape[-1]
    kd = cfg.mm_dtype or X_node.dtype
    return nn.matmul(X_node, lp["lin_r"]["w"][:d], cfg.mm_dtype).to(kd)


def _node_key_rows(lp: Dict, cfg: LPFormerConfig, X_node: torch.Tensor,
                   ctx: ContextTables) -> KeyRows:
    """The fused route's node half of the keys, by id: the projected node
    table (``_project_nodes``) and the context ids, which the fused op's
    kernels read row by row. No gather and no pad row: the invalid slots'
    pad id N is never read (the kernels walk the valid slots alone, and
    the plain versions give those slots zero rows)."""
    with profiling.span("model.keys"):
        return KeyRows(_project_nodes(lp, cfg, X_node), ctx.ids)


def _node_keys(lp: Dict, cfg: LPFormerConfig, X_node: torch.Tensor,
               ctx: ContextTables) -> torch.Tensor:
    """The dense route's node half of the keys, [B, C, H*O]: the projected
    node table (``_project_nodes``) gathered by the context ids. Row N is
    a zero pad row: invalid slots carry the pad id N, so they gather it
    (the JAX package spreads them over real rows instead, a TPU
    gather-engine workaround); either way no route reads an invalid slot's
    key (alpha is exactly 0 there)."""
    with profiling.span("model.keys"):
        X_proj = _project_nodes(lp, cfg, X_node)
        X_proj = torch.cat([X_proj, X_proj.new_zeros((1, X_proj.shape[1]))],
                           dim=0)
        return gather_rows_valid(X_proj, ctx.ids, ctx.valid)


def _project_keys(lp: Dict, params: Dict, cfg: LPFormerConfig,
                  X_node: torch.Tensor, ctx: ContextTables) -> torch.Tensor:
    """The dense route's keys xj = [x_v || pe_v] @ W_r + b_r [B, C, H*O],
    without the [B, C, 2*dim] table: the gathered node half
    (``_node_keys``) plus the PE folded into W_r's PE half, plus b_r, all
    in the key dtype."""
    d = X_node.shape[-1]
    W = lp["lin_r"]["w"]
    kd = cfg.mm_dtype or X_node.dtype
    xj = _node_keys(lp, cfg, X_node, ctx)
    xj = xj + _pos_encodings(params, cfg, ctx, W_fold=W[d:], out_dtype=kd)
    if "b" in lp["lin_r"]:
        xj = xj + lp["lin_r"]["b"].to(kd)
    return xj


def _att_layer_apply(
    lp: Dict, cfg: LPFormerConfig, edge_x: torch.Tensor, xj: torch.Tensor,
    valid: torch.Tensor, gen: Optional[torch.Generator] = None,
    train: bool = False,
):
    """The dense route's attention layer with H heads (reference:
    layers.py:193-224):
      score(v) = att . leaky_relu(xj_v * (W_l x_a + W_l x_b), 0.2)
      out      = sum_v softmax_v(score) xj_v,
    the softmax over each link's valid slots, then bias, post-LayerNorm
    and dropout (layers.py:78-80). Returns (out [B, H*O], alpha
    [B, C, H]); with bf16 keys the product, the logits and the softmax
    are f32 by promotion."""
    h = cfg.num_heads
    b_, c_, _ = xj.shape
    half = edge_x.shape[-1] // 2
    o = lp["lin_l"]["w"].shape[1] // h
    e1 = nn.linear_apply(lp["lin_l"], edge_x[:, :half], cfg.mm_dtype)
    e2 = nn.linear_apply(lp["lin_l"], edge_x[:, half:], cfg.mm_dtype)
    xj = xj.reshape(b_, c_, h, o)
    z = F.leaky_relu(xj * (e1.reshape(b_, 1, h, o) + e2.reshape(b_, 1, h, o)),
                     negative_slope=0.2)
    logits = (z * lp["att"]).sum(-1)                        # [B, C, H]
    alpha = masked_softmax(logits, valid[:, :, None], axis=1)
    out = (alpha[..., None] * xj).sum(1).reshape(b_, h * o) + lp["bias"]
    out = nn.layer_norm_apply(lp["post_norm"], out)
    return nn.dropout(gen, out, cfg.dropout, train), alpha


def remat_pairwise_on(cfg: LPFormerConfig, batch: int, slots: int) -> bool:
    """Whether the pairwise block is recomputed in the backward:
    ``cfg.remat_pairwise``, or when it is None, whether the largest
    activation it holds for the backward, [B, C, dim] f32 keys, exceeds
    2e9 bytes (the JAX package's rule, link_transformer.py:518-528)."""
    if cfg.remat_pairwise is not None:
        return cfg.remat_pairwise
    return batch * slots * cfg.dim * 4 > 2e9


def _checkpoint_with_generator(fn, gen, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant). The
    checkpoint restores only the default RNGs, and ``fn`` draws its
    dropout masks from ``gen``: so the recompute in the backward runs from
    the state ``gen`` held at the forward, and ``gen`` gets back the state
    it held before the recompute."""
    start = None if gen is None else gen.get_state()
    runs = [0]

    def run(*a):
        runs[0] += 1
        if gen is None or runs[0] == 1:
            return fn(*a)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return fn(*a)
        finally:
            gen.set_state(now)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


def calc_pairwise(
    params: Dict, cfg: LPFormerConfig, X_node: torch.Tensor,
    src: torch.Tensor, tgt: torch.Tensor, ctx: ContextTables, *,
    gen: Optional[torch.Generator] = None, train: bool = False,
    return_weights: bool = False,
):
    """Pairwise term over the extracted context table
    (reference: link_transformer.py:132-178): (pairwise [B, dim], alpha),
    alpha the last attention layer's weights [B, C, H] with
    ``return_weights`` and None otherwise. The route is the module
    docstring's rule. The attention layers, their keys included, are
    rematerialised in the backward when ``remat_pairwise_on`` says so,
    and never under ``return_weights``."""
    feats = torch.cat([gather_rows(X_node, src), gather_rows(X_node, tgt)],
                      dim=-1)
    fused = (cfg.use_pallas_attention is not False and cfg.num_heads == 1
             and not return_weights)

    def attend(X_node, feats):
        alpha = None
        for lp in params["att_layers"]:
            if fused:
                # the PE half is computed inside the fused op from the
                # [B, C] PPR tables
                feats = _att_layer_apply_fused(
                    lp, params, cfg, feats,
                    _node_key_rows(lp, cfg, X_node, ctx), ctx, gen, train)
            else:
                feats, alpha = _att_layer_apply(
                    lp, cfg, feats,
                    _project_keys(lp, params, cfg, X_node, ctx), ctx.valid,
                    gen, train)
        return feats, alpha

    if (torch.is_grad_enabled() and not return_weights
            and remat_pairwise_on(cfg, *ctx.ids.shape)):
        feats, alpha = _checkpoint_with_generator(attend, gen, X_node, feats)
    else:
        feats, alpha = attend(X_node, feats)

    counts = ctx.counts  # [B, 4]: cns, 1hop, non1hop, neighbours
    if cfg.mask_mode == "cn":
        cnt = counts[:, 0:1]
    elif cfg.mask_mode == "1-hop":
        cnt = torch.cat([counts[:, 0:1], counts[:, 1:2], counts[:, 3:4]],
                        dim=-1)
    else:
        cnt = counts
    feats = torch.cat([feats, cnt], dim=-1)
    feats = nn.mlp_apply(params["pairwise_lin"], feats, mm_dtype=cfg.mm_dtype)
    return feats, (alpha if return_weights else None)


def forward(
    params: Dict, cfg: LPFormerConfig, graph: GraphBundle,
    src: torch.Tensor, tgt: torch.Tensor, *,
    gen: Optional[torch.Generator] = None, train: bool = False,
    mask_ranks: Optional[torch.Tensor] = None,
    prop_edge_w: Optional[torch.Tensor] = None,
    X_node: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Edge representation h(a, b) [B, 2*dim]
    (reference: link_transformer.py:82-107). Pass ``X_node`` to reuse a
    propagated encoding (the propagate-once eval path, and the shared
    propagation of a training step); ``mask_ranks`` is the batch's
    masked-rank bitmap (``ops/masking.batch_mask_ranks``);
    ``prop_edge_w`` the propagation weights to use in place of the
    bundle's (``propagate``'s ``edge_w``)."""
    params = nn.cast_matmul_weights(params, cfg.mm_dtype)
    if X_node is None:
        X_node = propagate(params, cfg, graph, gen=gen, train=train,
                           edge_w=prop_edge_w)
    elementwise = nn.mlp_apply(
        params["elementwise_lin"],
        gather_rows(X_node, src) * gather_rows(X_node, tgt),
        mm_dtype=cfg.mm_dtype,
    )
    with profiling.span("model.context"):
        ctx = extract_context(graph.adj_rows, graph.ppr_rows, src, tgt,
                              cfg.context, mask_ranks=mask_ranks, gen=gen,
                              train=train)
        if profiling.active():
            valid = profiling.real_rows(ctx.valid)
            profiling.count("context.valid_slots", valid)
            profiling.count("context.table_slots", valid.numel())
            profiling.count("context.candidate_slots", valid.shape[0] * (
                cfg.context.candidate_columns(graph.adj_rows.nbrs.shape[1],
                                              graph.ppr_rows.nbrs.shape[1])))
            profiling.count("context.dropped_slots",
                            profiling.real_rows(ctx.overflow))
    pairwise, _ = calc_pairwise(params, cfg, X_node, src, tgt, ctx,
                                gen=gen, train=train)
    return torch.cat([elementwise, pairwise], dim=-1)


def score_links(params: Dict, cfg: LPFormerConfig, h: torch.Tensor, *,
                gen: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """sigmoid(mlp_score(h)) -> [B] link probabilities
    (reference: other_models.py:173-179)."""
    with profiling.span("model.score"):
        return nn.mlp_apply(
            nn.cast_matmul_weights(params["score"], cfg.mm_dtype), h,
            drop=cfg.pred_drop, gen=gen, train=train, sigmoid=True,
            mm_dtype=cfg.mm_dtype,
        )
