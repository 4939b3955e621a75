"""The bench's synthetic configurations, used by chip_smoke.py,
``profile_eval`` and ``profile_train``:

  * collab-like: the JAX package's default bench shape (bench.py:61-63
    PRESETS["collab-like"], the bf16 default of :172 and the synthetic
    dataset of :245-256), on the combined context table (the bench's
    default), and on the classic per-class table of its per-class budgets
    (the bench's --no-combined A/B);
  * ddi-like: bench.py:80-91 PRESETS["ddi-like"], a small dense graph at
    dim 256 (the reference's >32 GB-GPU shape), on the combined table of
    budget 128, with the same synthetic generator settings (:245-253);
  * citation2-like: bench.py:64-73 PRESETS["citation2-like"], a big sparse
    graph (1M nodes, so its propagation runs the tiled BlockedBELL) at dim
    64 and batch 32768, on the combined table of budget 96, with the same
    synthetic generator settings (:245-256);
  * ppa-like: bench.py:74-79 PRESETS["ppa-like"], the densest big graph
    (576,000 nodes, 15M train edges, mean degree ~48, so its propagation
    runs the BlockedBELL of kb 5) at dim 64 and batch 32768, on the
    combined table of budget 96, with the same synthetic generator
    settings (:245-256) and ``residual`` as configs/ogbl-ppa-existing.json
    and scripts/replicate_existing.sh set it; and on the classic table of
    its per-class budgets (the bench's --no-combined A/B), where the
    pairwise block's remat turns on by the JAX package's rule;
  * pubmed-like: ``configs/pubmed-existing.json`` at its published widths
    (the repo's one ``mask_input`` configuration), every field the JSON
    leaves out at the JAX CLI's default (lpformer_tpu/cli/run.py), on the
    classic table of DATA_REQUEST.md's Planetoid budgets, over a
    synthetic power-law graph of Pubmed's size (the real splits are not
    in the repository)."""
from __future__ import annotations

import dataclasses

from lpformer_tpu_torch.models.config import LPFormerConfig

COLLAB_LIKE_CONFIG = LPFormerConfig(
    dim=128, gnn_layers=3, num_heads=1, trans_layers=1, pred_layers=2,
    thresh_cn=0.0, thresh_1hop=1e-2, thresh_non1hop=1e-2,
    budget_combined=128, matmul_dtype="bfloat16",
)
# bench.py --no-combined (:155-157, :201-202): the per-class budgets of
# bench.py:61-63 on the classic table, C = 64 + 128 + 128 = 320 slots
COLLAB_LIKE_CLASSIC_CONFIG = dataclasses.replace(
    COLLAB_LIKE_CONFIG, budget_combined=None, budget_cn=64,
    budget_onehop=128, budget_non1hop=128)
COLLAB_LIKE_DATA = dict(
    seed=0, num_nodes=50_000, num_train=400_000, num_eval=1000,
    feat_dim=128, eps=5e-4, adj_cap=96, ppr_cap=256,
)
COLLAB_LIKE_BATCH = 4096

# bench.py:89-91: 4,096 nodes, 500,000 train edges, feat = dim = 256, batch
# 4096, combined budget 128 (its per-class budgets 128 / 320 / 320 are the
# classic table's, C = 768)
DDI_LIKE_CONFIG = dataclasses.replace(COLLAB_LIKE_CONFIG, dim=256)
DDI_LIKE_CLASSIC_WIDTHS = (128, 320, 320)
# the same on the classic table (C = 768), where B * C * dim * 4 = 3.2e9
# bytes turns the pairwise block's remat on (remat_pairwise_on)
DDI_LIKE_CLASSIC_CONFIG = dataclasses.replace(
    DDI_LIKE_CONFIG, budget_combined=None,
    **dict(zip(("budget_cn", "budget_onehop", "budget_non1hop"),
               DDI_LIKE_CLASSIC_WIDTHS)))
DDI_LIKE_DATA = dict(
    seed=0, num_nodes=4_096, num_train=500_000, num_eval=1000,
    feat_dim=256, eps=5e-4, adj_cap=96, ppr_cap=256,
)
DDI_LIKE_BATCH = 4096

# bench.py:64-73: 1,000,000 nodes, 5,000,000 train edges, feat 96, dim 64,
# batch 32768, 3 GCN layers, the combined budget 96 (its per-class budgets
# 32 / 64 / 64 are the classic table's), bf16 matmul inputs (:172)
CITATION2_LIKE_CONFIG = dataclasses.replace(
    COLLAB_LIKE_CONFIG, dim=64, budget_combined=96, budget_cn=32,
    budget_onehop=64, budget_non1hop=64)
CITATION2_LIKE_DATA = dict(
    seed=0, num_nodes=1_000_000, num_train=5_000_000, num_eval=1000,
    feat_dim=96, eps=5e-4, adj_cap=96, ppr_cap=256,
)
CITATION2_LIKE_BATCH = 32_768

# bench.py:74-79: 576,000 nodes, 15,000,000 train edges, feat = dim = 64,
# batch 32768, 3 GCN layers, the combined budget 96 (its per-class budgets
# 64 / 128 / 128 are the classic table's), bf16 matmul inputs (:172);
# residual=True from configs/ogbl-ppa-existing.json (and the ogbl-ppa line
# of scripts/replicate_existing.sh); the rest at the bench's defaults
PPA_LIKE_CONFIG = dataclasses.replace(
    COLLAB_LIKE_CONFIG, dim=64, budget_combined=96, budget_cn=64,
    budget_onehop=128, budget_non1hop=128, residual=True)
# the same on the classic table (C = 320), where B * C * dim * 4 = 2.7e9
# bytes turns the pairwise block's remat on (remat_pairwise_on)
PPA_LIKE_CLASSIC_CONFIG = dataclasses.replace(
    PPA_LIKE_CONFIG, budget_combined=None)
# bench.py:245-256's synthetic_dataset settings at the preset's sizes
PPA_LIKE_DATA = dict(
    seed=0, num_nodes=576_000, num_train=15_000_000, num_eval=1000,
    feat_dim=64, eps=5e-4, adj_cap=96, ppr_cap=256,
)
PPA_LIKE_BATCH = 32_768

# configs/pubmed-existing.json: dim 128, 1 GCN layer, every dropout 0.3,
# thresholds 0 / 0.01 / 0.01, mask_input; the CLI's defaults for the rest
# (lpformer_tpu/cli/run.py: f32 matmuls, 1 head, 1 transformer layer, 2
# score layers, the classic table); DATA_REQUEST.md:92's Planetoid
# budgets 32 / 96 / 96 (C = 224) and caps adj 64 / ppr 256
PUBMED_LIKE_CONFIG = LPFormerConfig(
    dim=128, gnn_layers=1, num_heads=1, trans_layers=1, pred_layers=2,
    thresh_cn=0.0, thresh_1hop=1e-2, thresh_non1hop=1e-2,
    dropout=0.3, gnn_drop=0.3, att_drop=0.3, feat_drop=0.3, pred_drop=0.3,
    matmul_dtype="float32", budget_cn=32, budget_onehop=96,
    budget_non1hop=96,
)
# Pubmed's size: 19,717 nodes, 500 features, 44,324 undirected edges of
# which HeaRT's fixed 85/5/10 split trains on 37,676 and validates on
# 2,216; the config's PPR eps 1e-5
PUBMED_LIKE_DATA = dict(
    seed=0, num_nodes=19_717, num_train=37_676, num_eval=2_216,
    feat_dim=500, eps=1e-5, adj_cap=64, ppr_cap=256, mask_input=True,
)
# the config's batch_size, lr and l2 (decay 1: the TrainArgs default)
PUBMED_LIKE_BATCH = 1024
PUBMED_LIKE_LR, PUBMED_LIKE_L2 = 1e-3, 1e-4
