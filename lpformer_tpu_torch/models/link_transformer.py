"""LPFormer for link prediction (counterpart of
``lpformer_tpu/models/link_transformer.py``), eval and train paths.

  h(a, b) = [ MLP(x_a * x_b)  ||  pairwise(a, b) ]               (:82-107)
  pairwise = MLP( attention over a's and b's context nodes || counts )

The attention is GATv2-style over each link's context set, with
symmetrised PPR positional encodings per node class (reference:
src/models/link_transformer.py:132-211, src/modules/layers.py:193-224).
It runs as ONE fused op over the context table, a hand-written CUDA
kernel on a CUDA tensor and its plain torch version on a CPU tensor (the
counterparts of the JAX package's Pallas kernels, which it switches on by
itself on a TPU):

  * the classic class-blocked table (``budget_combined=None``, the
    default): ``ops/pe_attention.py``, with the blocks' widths;
  * the combined class-tagged table: ``ops/pe_attention_mixed.py``, with
    a per-slot encoder index.

Parameters are the JAX package's pytree as nested dicts of tensors
(``utils/params.py``). ``num_heads > 1`` is not ported yet.

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

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.graph.containers import GraphBundle
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.models.gcn import gcn_apply, gcn_init
from lpformer_tpu_torch.nn import core as nn
from lpformer_tpu_torch.ops.context import ContextTables, extract_context
from lpformer_tpu_torch.ops.gather import gather_rows, gather_rows_valid
from lpformer_tpu_torch.ops.pe_attention import fused_pe_link_attention
from lpformer_tpu_torch.ops.pe_attention_mixed import (
    fused_pe_link_attention_mixed,
)


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
              train: bool = False) -> torch.Tensor:
    """GNN node encoding + final LayerNorm -> X_node [N, dim]
    (reference: link_transformer.py:110-129, node_encoder.py:35-44)."""
    params = nn.cast_matmul_weights(params, cfg.mm_dtype)
    if graph.ell is None:
        raise NotImplementedError("propagation needs the BucketedELL layout")
    x = nn.dropout(gen, graph.x, cfg.feat_drop, train)
    x = gcn_apply(
        params["node_encoder"], x, graph.ell, graph.w_diag,
        gnn_drop=cfg.gnn_drop, residual=cfg.residual, relu=cfg.relu,
        gen=gen, train=train, mm_dtype=cfg.mm_dtype,
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


def _att_layer_apply(
    lp: Dict, params: Dict, cfg: LPFormerConfig, edge_x: torch.Tensor,
    xj_node: torch.Tensor, ctx: ContextTables,
    gen: Optional[torch.Generator] = None, train: bool = False,
) -> torch.Tensor:
    """One attention layer through the fused PE + attention op. The PE
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
        out, _, _ = fused_pe_link_attention(
            xj_node, ctx.src_ppr, ctx.tgt_ppr, ctx.valid, e1 + e2, *weights,
            class_widths=cfg.context.class_budgets)
    else:
        ecls = torch.zeros_like(ctx.cls)
        for k, (_, code) in enumerate(_encoder_codes(cfg)):
            ecls = torch.where(ctx.cls == code, k, ecls)
        out, _, _ = fused_pe_link_attention_mixed(
            xj_node, ctx.src_ppr, ctx.tgt_ppr, ctx.valid, ecls, e1 + e2,
            *weights)
    out = nn.layer_norm_apply(lp["post_norm"], out)
    return nn.dropout(gen, out, cfg.dropout, train)


def calc_pairwise(
    params: Dict, cfg: LPFormerConfig, X_node: torch.Tensor,
    src: torch.Tensor, tgt: torch.Tensor, ctx: ContextTables, *,
    gen: Optional[torch.Generator] = None, train: bool = False,
) -> torch.Tensor:
    """Pairwise term over the extracted context table
    (reference: link_transformer.py:132-178)."""
    if cfg.num_heads != 1:
        raise NotImplementedError("num_heads > 1 is not ported yet")
    feats = torch.cat([gather_rows(X_node, src), gather_rows(X_node, tgt)],
                      dim=-1)
    d = X_node.shape[-1]
    kd = cfg.mm_dtype or X_node.dtype
    for lp in params["att_layers"]:
        # node half of the keys projected once in [N] space; the PE half
        # is computed inside the fused op from the [B, C] PPR tables
        W = lp["lin_r"]["w"]
        X_proj = nn.matmul(X_node, W[:d], cfg.mm_dtype).to(kd)
        # pad row N = zeros. Invalid slots carry the pad id N, so they
        # gather this zero row (the JAX package spreads them over real rows
        # instead, a TPU gather-engine workaround); either way the op never
        # reads an invalid slot's key
        X_proj = torch.cat(
            [X_proj, torch.zeros((1, W.shape[1]), dtype=kd,
                                 device=X_proj.device)], dim=0)
        xj_node = gather_rows_valid(X_proj, ctx.ids, ctx.valid)  # [B, C, O]
        feats = _att_layer_apply(lp, params, cfg, feats, xj_node, ctx,
                                 gen, train)

    counts = ctx.counts  # [B, 4]: cns, 1hop, non1hop, neighbours
    if cfg.mask_mode == "cn":
        cnt = counts[:, 0:1]
    elif cfg.mask_mode == "1-hop":
        cnt = torch.cat([counts[:, 0:1], counts[:, 1:2], counts[:, 3:4]],
                        dim=-1)
    else:
        cnt = counts
    feats = torch.cat([feats, cnt], dim=-1)
    return nn.mlp_apply(params["pairwise_lin"], feats, mm_dtype=cfg.mm_dtype)


def forward(
    params: Dict, cfg: LPFormerConfig, graph: GraphBundle,
    src: torch.Tensor, tgt: torch.Tensor, *,
    gen: Optional[torch.Generator] = None, train: bool = False,
    mask_ranks: Optional[torch.Tensor] = None,
    X_node: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Edge representation h(a, b) [B, 2*dim]
    (reference: link_transformer.py:82-107). Pass ``X_node`` to reuse a
    propagated encoding (the propagate-once eval path, and the shared
    propagation of a training step); ``mask_ranks`` is the batch's
    masked-rank bitmap (``ops/masking.batch_mask_ranks``)."""
    params = nn.cast_matmul_weights(params, cfg.mm_dtype)
    if X_node is None:
        X_node = propagate(params, cfg, graph, gen=gen, train=train)
    elementwise = nn.mlp_apply(
        params["elementwise_lin"],
        gather_rows(X_node, src) * gather_rows(X_node, tgt),
        mm_dtype=cfg.mm_dtype,
    )
    ctx = extract_context(graph.adj_rows, graph.ppr_rows, src, tgt,
                          cfg.context, mask_ranks=mask_ranks, gen=gen,
                          train=train)
    pairwise = calc_pairwise(params, cfg, X_node, src, tgt, ctx, gen=gen,
                             train=train)
    return torch.cat([elementwise, pairwise], dim=-1)


def score_links(params: Dict, cfg: LPFormerConfig, h: torch.Tensor, *,
                gen: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """sigmoid(mlp_score(h)) -> [B] link probabilities
    (reference: other_models.py:173-179)."""
    return nn.mlp_apply(
        nn.cast_matmul_weights(params["score"], cfg.mm_dtype), h,
        drop=cfg.pred_drop, gen=gen, train=train, sigmoid=True,
        mm_dtype=cfg.mm_dtype,
    )
