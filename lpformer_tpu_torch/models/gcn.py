"""GCN node encoder (counterpart of ``lpformer_tpu/models/gcn.py``).

Per layer, the reference's order: conv -> LayerNorm -> (dropout) -> ReLU ->
residual when dims match (reference: src/models/other_models.py:10-76).
GCNConv is PyG's: x' = A_hat (x W) + b with A_hat = D^-1/2 (A + I) D^-1/2.
The propagation runs on the layout the caller passes, in the JAX
package's order of preference (``gcn_apply``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from lpformer_tpu_torch.graph.containers import BucketedELL
from lpformer_tpu_torch.nn import core as nn
from lpformer_tpu_torch.ops import spmm


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
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_w: torch.Tensor,
    num_nodes: int,
    *,
    gnn_drop: float = 0.0,
    residual: bool = False,
    relu: bool = True,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    mm_dtype=None,
    ell=None,
    norm=None,
    blk=None,
    bbell=None,
) -> torch.Tensor:
    """GCN over the dst-sorted COO ``edge_src/dst/w``. ``norm`` is the
    host-precomputed (w_norm, diag) of the static weights; without it the
    normalisation is recomputed on the device, once for all layers. Each
    layer's SpMM takes the first layout present, as the JAX package's
    does: ``bbell`` (static norm only), then ``blk`` (its static ``tw``
    under a static norm, else re-weighted through its edge ids), then
    ``ell`` (a BucketedELL or an ELLAdjacency: its static slot weights
    under a static norm, else re-weighted through its slots' edge ids),
    then the COO. With ``train`` and a generator, each layer draws one
    ``gnn_drop`` dropout mask between its LayerNorm and its ReLU."""
    if norm is not None:
        w_norm, diag = norm
    else:
        w_norm, diag = spmm.gcn_norm_device(edge_src, edge_dst, edge_w,
                                            num_nodes)
    ell_static = norm is not None and ell is not None and ell.w_slots is not None
    blk_static = norm is not None and blk is not None and blk.tw is not None
    lns = params.get("lns")
    for i, conv in enumerate(params["convs"]):
        xi = nn.matmul(x, conv["w"], mm_dtype)
        if bbell is not None and norm is not None:
            xi = spmm.spmm_bbell(bbell, xi, diag=diag, gather_dtype=mm_dtype)
        elif blk is not None:
            xi = spmm.spmm_blocked(blk, None if blk_static else w_norm, xi,
                                   diag=diag, gather_dtype=mm_dtype)
        elif ell is not None:
            spmm_fn = (spmm.spmm_bell if isinstance(ell, BucketedELL)
                       else spmm.spmm_ell)
            xi = spmm_fn(ell, None if ell_static else w_norm, xi, diag=diag,
                         gather_dtype=mm_dtype)
        else:
            xi = spmm.spmm(edge_src, edge_dst, w_norm, xi, num_nodes,
                           diag=diag, gather_dtype=mm_dtype)
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
