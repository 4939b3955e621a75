"""GCN node encoder (counterpart of ``lpformer_tpu/models/gcn.py``).

Per layer, the reference's order: conv -> LayerNorm -> (dropout) -> ReLU ->
residual when dims match (reference: src/models/other_models.py:10-76).
GCNConv is PyG's: x' = A_hat (x W) + b with A_hat = D^-1/2 (A + I) D^-1/2.
The port runs the BucketedELL layout with the bundle's static
normalisation; the other propagation layouts come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from lpformer_tpu_torch.nn import core as nn
from lpformer_tpu_torch.ops.spmm import spmm_bell


def gcn_init(
    gen: torch.Generator,
    in_dim: int,
    hid_dim: int,
    out_dim: int,
    num_layers: int,
    layer_norm: bool = True,
    device=None,
) -> Dict:
    if num_layers == 1:
        dims = [in_dim, out_dim]
    else:
        dims = [in_dim] + [hid_dim] * (num_layers - 1) + [out_dim]
    convs, lns = [], []
    for i in range(num_layers):
        lin = nn.linear_init(gen, dims[i], dims[i + 1], bias=False,
                             kind="glorot", device=device)
        lin["bias"] = torch.zeros(dims[i + 1], dtype=torch.float32,
                                  device=device)
        convs.append(lin)
        if layer_norm:
            lns.append(nn.layer_norm_init(dims[i + 1], device))
    p: Dict = {"convs": convs}
    if layer_norm:
        p["lns"] = lns
    return p


def gcn_apply(
    params: Dict,
    x: torch.Tensor,
    ell,
    w_diag: torch.Tensor,
    *,
    gnn_drop: float = 0.0,
    residual: bool = False,
    relu: bool = True,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    mm_dtype=None,
) -> torch.Tensor:
    """GCN over the BucketedELL ``ell`` with its prelaid static weights;
    ``w_diag`` is the normalised self-loop coefficient. With ``train`` and
    a generator, each layer draws one ``gnn_drop`` dropout mask between
    its LayerNorm and its ReLU."""
    lns = params.get("lns")
    for i, conv in enumerate(params["convs"]):
        xi = nn.matmul(x, conv["w"], mm_dtype)
        xi = spmm_bell(ell, xi, diag=w_diag, gather_dtype=mm_dtype)
        xi = xi + conv["bias"]
        if lns is not None:
            xi = nn.layer_norm_apply(lns[i], xi)
        xi = nn.dropout(gen, xi, gnn_drop, train)
        if relu:
            xi = torch.relu(xi)
        if residual and x.shape[-1] == xi.shape[-1]:
            x = x + xi
        else:
            x = xi
    return x
