"""Scatter-free SpMM for GCN propagation over a BucketedELL (counterpart of
``lpformer_tpu/ops/spmm.py:spmm_bell``).

It replaces the torch_sparse CSR SpMM inside the reference's GCNConv
(reference: src/models/other_models.py:35-48,66). The normalised self loop
is never stored: it is the elementwise ``diag * x`` term. Plain torch
gathers and sums, as XLA ran it in the reference.

The propagation adjacency is symmetric, so the backward is the same
operator on the cotangent, d/dx (A x) = A ct: the same tier sweeps, with
no scatter in either direction (``spmm_bell`` is a
``torch.autograd.Function``, as the JAX package's is a ``custom_vjp``).
"""
from __future__ import annotations

from typing import Optional

import torch

# bound on one tier chunk's gathered [Nb, kc, D] transient, as in the
# reference's _spmm_bell_raw
_CHUNK_BYTES = 256e6


def _tier_sweep(nb, ws, xg, out_dtype, kc):
    """sum_k ws[:, k] * x[nb[:, k]] for one [Nb, cap] tier, in slot chunks
    of ``kc`` so the gathered transient stays bounded."""
    n_t, cap = nb.shape
    acc = torch.zeros((n_t, xg.shape[-1]), dtype=out_dtype, device=xg.device)
    for lo in range(0, cap, kc):
        g = xg[nb[:, lo:lo + kc].long()].to(out_dtype)       # [Nb, kc, D]
        acc = acc + torch.einsum("nk,nkd->nd", ws[:, lo:lo + kc], g)
    return acc


def _spmm_bell_raw(bell, x, diag, gather_dtype):
    n, d = x.shape
    xg = x if gather_dtype is None else x.to(gather_dtype)
    bytes_per = xg.element_size()
    outs = []
    for nb, ws, cap in zip(bell.nbs, bell.w_slots, bell.caps):
        kc = int(max(1, min(cap, _CHUNK_BYTES // max(nb.shape[0] * d * bytes_per, 1))))
        outs.append(_tier_sweep(nb, ws, xg, x.dtype, kc))
    outs.append(torch.zeros((1, d), dtype=x.dtype, device=x.device))
    out = torch.cat(outs, dim=0)[bell.outmap.long()]
    if diag is not None:
        out = out + diag[:, None] * x
    return out


class _SpmmBellSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bell, diag, gather_dtype):
        ctx.bell, ctx.gather_dtype = bell, gather_dtype
        ctx.save_for_backward(diag)
        return _spmm_bell_raw(bell, x, diag, gather_dtype)

    @staticmethod
    def backward(ctx, ct):
        (diag,) = ctx.saved_tensors
        dx = _spmm_bell_raw(ctx.bell, ct.contiguous(), diag, ctx.gather_dtype)
        return dx, None, None, None


def spmm_bell(
    bell,
    x: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    gather_dtype=None,
) -> torch.Tensor:
    """out[v] = sum_{(u,v) in E} w_uv * x[u] (+ diag[v] * x[v]) with the
    BucketedELL's static slot weights of a symmetric adjacency.
    ``gather_dtype`` (bf16) rounds the gathered rows as the reference's
    bf16 gather does, in both directions; products and sums stay in x's
    dtype."""
    return _SpmmBellSymmetric.apply(x, bell, diag, gather_dtype)
