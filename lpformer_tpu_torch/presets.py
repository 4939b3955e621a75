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
    synthetic generator settings (:245-256)."""
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
