"""Model configuration (counterpart of ``lpformer_tpu/models/config.py``).

The fields the eval and training paths read, with the JAX package's names
and defaults. The TPU-only switches (``use_pallas_attention``,
``remat_pairwise``) are not here: on a CUDA tensor the port always runs
the hand-written kernels, and it has no remat yet.
"""
from __future__ import annotations

import dataclasses

import torch

from lpformer_tpu_torch.ops.context import ContextConfig


@dataclasses.dataclass(frozen=True)
class LPFormerConfig:
    dim: int = 128
    num_heads: int = 1
    gnn_layers: int = 2
    trans_layers: int = 1
    pred_layers: int = 2

    thresh_cn: float = 0.0
    thresh_1hop: float = 1e-2
    thresh_non1hop: float = 1e-2

    residual: bool = False
    layer_norm: bool = True
    relu: bool = True

    dropout: float = 0.2      # post-attention dropout in the transformer layer
    gnn_drop: float = 0.2
    att_drop: float = 0.1     # context-node subsampling rate
    feat_drop: float = 0.0
    pred_drop: float = 0.0

    # "bfloat16": every matmul takes bf16 inputs and accumulates in f32
    # (nn/core.py:matmul), and the context key tables are bf16
    matmul_dtype: str = "float32"

    # static per-class context budgets: the widths of the classic table's
    # class blocks [cn | 1-hop | >1-hop]
    budget_cn: int = 128
    budget_onehop: int = 256
    budget_non1hop: int = 128
    # combined class-tagged context table: one cross-class budget replacing
    # the per-class blocks. None = the classic per-class blocks
    budget_combined: "int | None" = None

    @property
    def mm_dtype(self):
        return torch.bfloat16 if self.matmul_dtype == "bfloat16" else None

    @property
    def mask_mode(self) -> str:
        return self.context.mask_mode

    @property
    def context(self) -> ContextConfig:
        return ContextConfig.from_thresholds(
            thresh_cn=self.thresh_cn,
            thresh_1hop=self.thresh_1hop,
            thresh_non1hop=self.thresh_non1hop,
            budget_cn=self.budget_cn,
            budget_onehop=self.budget_onehop,
            budget_non1hop=self.budget_non1hop,
            att_drop=self.att_drop,
            budget_combined=self.budget_combined,
        )

    @property
    def count_dim(self) -> int:
        return self.context.count_dim

    @property
    def out_dim(self) -> int:
        # elementwise dim + pairwise dim (reference link_transformer.py:50)
        return self.dim * 2
