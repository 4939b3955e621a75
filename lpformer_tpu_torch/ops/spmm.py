"""Sparse matrix-dense matrix products (SpMM) for GCN propagation
(counterpart of ``lpformer_tpu/ops/spmm.py``).

They replace the torch_sparse CSR SpMM inside the reference's GCNConv
(reference: src/models/other_models.py:35-48,66). The normalised self loop
is never stored: it is the elementwise ``diag * x`` term. Plain torch
gathers and sums, as XLA ran them in the reference. One function per
layout of ``graph/containers.py``:

  * ``spmm``: the dst-sorted COO, gather + index_add;
  * ``spmm_ell``: the hybrid ELLAdjacency, slot sums + an overflow COO;
  * ``spmm_bell``: the BucketedELL, per-tier slot sums, no scatter;
  * ``spmm_bbell``: the BlockedBELL, a BucketedELL sweep per (dst block,
    src block) tile, each gathering from one slice of x;
  * ``spmm_blocked``: the BlockedCOO, per-tile gather + index_add.

The propagation adjacency is symmetric, so each backward is the same
operator on the cotangent, d/dx (A x) = A ct: the same sweeps, no
transposed layout (each is a ``torch.autograd.Function``, as the JAX
package's is a ``custom_vjp``). GCN normalisation D^-1/2 (A + I) D^-1/2 is
precomputed on the host for a static graph (``data/dataset.py``) or
recomputed on the device by ``gcn_norm_device``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# bound on one tier chunk's gathered [Nb, kc, D] transient, as in the
# reference's _spmm_bell_raw
_CHUNK_BYTES = 256e6


def gcn_norm_device(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_w: torch.Tensor,
    num_nodes: int,
    fill_value: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GCN normalisation on the device: (w_norm [E], diag [N]), with
    ``diag`` the normalised self-loop coefficient fill / (deg + fill).
    PyG's gcn_norm: deg = rowsum(A) + fill."""
    deg = torch.zeros(num_nodes, dtype=edge_w.dtype, device=edge_w.device)
    deg = deg.index_add_(0, edge_dst.long(), edge_w) + fill_value
    dinv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    w_norm = dinv[edge_src.long()] * edge_w * dinv[edge_dst.long()]
    return w_norm, dinv * fill_value * dinv


def _spmm_raw(edge_src, edge_dst, edge_w, x, num_nodes, diag, gather_dtype):
    src_vals = x if gather_dtype is None else x.to(gather_dtype)
    gathered = src_vals[edge_src.long()].to(x.dtype) * edge_w[:, None]
    out = torch.zeros((num_nodes, x.shape[-1]), dtype=x.dtype,
                      device=x.device).index_add_(0, edge_dst.long(),
                                                  gathered)
    if diag is not None:
        out = out + diag[:, None] * x
    return out


class _SpmmSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edge_src, edge_dst, edge_w, num_nodes, diag,
                gather_dtype):
        ctx.num_nodes, ctx.gather_dtype = num_nodes, gather_dtype
        ctx.save_for_backward(edge_src, edge_dst, edge_w, diag)
        return _spmm_raw(edge_src, edge_dst, edge_w, x, num_nodes, diag,
                         gather_dtype)

    @staticmethod
    def backward(ctx, ct):
        edge_src, edge_dst, edge_w, diag = ctx.saved_tensors
        dx = _spmm_raw(edge_src, edge_dst, edge_w, ct.contiguous(),
                       ctx.num_nodes, diag, ctx.gather_dtype)
        return dx, None, None, None, None, None, None


def spmm(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_w: torch.Tensor,
    x: torch.Tensor,
    num_nodes: int,
    diag: Optional[torch.Tensor] = None,
    symmetric: bool = True,
    gather_dtype=None,
) -> torch.Tensor:
    """out[v] = sum_{(u,v) in E} w_uv * x[u] (+ diag[v] * x[v]) over a
    dst-sorted COO. With ``symmetric`` (every adjacency here is
    symmetrised) the backward is the same product on the cotangent, and
    the edge weights and diag take no gradient; without it autograd
    differentiates the gather and the index_add (the check of the
    symmetric backward). ``gather_dtype`` (bf16) rounds the gathered rows;
    products and sums stay in x's dtype."""
    if symmetric:
        return _SpmmSymmetric.apply(x, edge_src, edge_dst, edge_w, num_nodes,
                                    diag, gather_dtype)
    return _spmm_raw(edge_src, edge_dst, edge_w, x, num_nodes, diag,
                     gather_dtype)


# --------------------------------------------------------------------------
# hybrid ELL + overflow COO
# --------------------------------------------------------------------------

def _spmm_ell_raw(ell, w_norm, x, diag, gather_dtype):
    """out[v] = sum_k w_slots[v, k] * x[nb[v, k]] (+ overflow + diag),
    the slots in chunks of at most 8 so the gathered transient stays
    bounded."""
    n, cap = ell.nb.shape
    d = x.shape[-1]
    kc = int(max(1, min(8, _CHUNK_BYTES // max(
        n * d * (gather_dtype or x.dtype).itemsize, 1))))
    if w_norm is None:      # static weights (ELLAdjacency.with_weights)
        w_slots, ov_w = ell.w_slots, ell.ov_w
    else:
        w_ext = torch.cat([w_norm, w_norm.new_zeros(1)])
        w_slots = w_ext[ell.slot_edge.long()]
        ov_w = w_ext[ell.ov_edge.long()]
    xg = x if gather_dtype is None else x.to(gather_dtype)
    out = torch.zeros_like(x) if diag is None else diag[:, None] * x
    for lo in range(0, cap, kc):
        g = xg[ell.nb[:, lo:lo + kc].long()].to(x.dtype)
        out = out + torch.einsum("nk,nkd->nd", w_slots[:, lo:lo + kc], g)
    if ell.ov_src.shape[0]:
        g = xg[ell.ov_src.long()].to(x.dtype) * ov_w[:, None]
        out = out + torch.zeros_like(out).index_add_(
            0, ell.ov_dst.long(), g)
    return out


class _SpmmEllSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ell, w_norm, diag, gather_dtype):
        ctx.ell, ctx.gather_dtype = ell, gather_dtype
        ctx.save_for_backward(w_norm, diag)
        return _spmm_ell_raw(ell, w_norm, x, diag, gather_dtype)

    @staticmethod
    def backward(ctx, ct):
        w_norm, diag = ctx.saved_tensors
        dx = _spmm_ell_raw(ctx.ell, w_norm, ct.contiguous(), diag,
                           ctx.gather_dtype)
        return dx, None, None, None, None


def spmm_ell(
    ell,
    w_norm: Optional[torch.Tensor],
    x: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    gather_dtype=None,
) -> torch.Tensor:
    """``spmm`` over an ELLAdjacency of a symmetric adjacency; ``w_norm``
    is indexed by the dst-sorted edge order the layout was built from, or
    None for its static slot weights."""
    return _SpmmEllSymmetric.apply(x, ell, w_norm, diag, gather_dtype)


# --------------------------------------------------------------------------
# degree-bucketed ELL (no overflow, no scatter)
# --------------------------------------------------------------------------

def _tier_sweep(nb, ws, xg, out_dtype, kc):
    """sum_k ws[:, k] * x[nb[:, k]] for one [Nb, cap] tier, in slot chunks
    of ``kc`` so the gathered transient stays bounded."""
    n_t, cap = nb.shape
    acc = torch.zeros((n_t, xg.shape[-1]), dtype=out_dtype, device=xg.device)
    for lo in range(0, cap, kc):
        g = xg[nb[:, lo:lo + kc].long()].to(out_dtype)       # [Nb, kc, D]
        acc = acc + torch.einsum("nk,nkd->nd", ws[:, lo:lo + kc], g)
    return acc


def _tier_chunk(nb, d, bytes_per, cap):
    return int(max(1, min(cap, _CHUNK_BYTES // max(nb.shape[0] * d * bytes_per,
                                                   1))))


def _spmm_bell_raw(bell, w_norm, x, diag, gather_dtype):
    n, d = x.shape
    xg = x if gather_dtype is None else x.to(gather_dtype)
    bytes_per = xg.element_size()
    if w_norm is None:
        w_slots = bell.w_slots
    else:
        if bell.slot_edges is None:
            raise ValueError(
                "dynamic re-weighting needs the slots' edge ids, but this "
                "BucketedELL was built with with_edge_ids=False")
        w_ext = torch.cat([w_norm, w_norm.new_zeros(1)])
        w_slots = [w_ext[se.long()] for se in bell.slot_edges]
    outs = []
    for nb, ws, cap in zip(bell.nbs, w_slots, bell.caps):
        outs.append(_tier_sweep(nb, ws, xg, x.dtype,
                                _tier_chunk(nb, d, bytes_per, cap)))
    outs.append(torch.zeros((1, d), dtype=x.dtype, device=x.device))
    out = torch.cat(outs, dim=0)[bell.outmap.long()]
    if diag is not None:
        out = out + diag[:, None] * x
    return out


class _SpmmBellSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bell, w_norm, diag, gather_dtype):
        ctx.bell, ctx.gather_dtype = bell, gather_dtype
        ctx.save_for_backward(w_norm, diag)
        return _spmm_bell_raw(bell, w_norm, x, diag, gather_dtype)

    @staticmethod
    def backward(ctx, ct):
        w_norm, diag = ctx.saved_tensors
        dx = _spmm_bell_raw(ctx.bell, w_norm, ct.contiguous(), diag,
                            ctx.gather_dtype)
        return dx, None, None, None, None


def spmm_bell(
    bell,
    w_norm: Optional[torch.Tensor],
    x: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    gather_dtype=None,
) -> torch.Tensor:
    """out[v] = sum_{(u,v) in E} w_uv * x[u] (+ diag[v] * x[v]) over a
    BucketedELL of a symmetric adjacency: ``w_norm=None`` uses the static
    slot weights; otherwise the slots re-gather ``w_norm`` (indexed by
    the dst-sorted edge order) through their edge ids, and ``w_norm``
    takes no gradient. ``gather_dtype`` (bf16) rounds the gathered rows
    as the reference's bf16 gather does, in both directions; products and
    sums stay in x's dtype."""
    return _SpmmBellSymmetric.apply(x, bell, w_norm, diag, gather_dtype)


# --------------------------------------------------------------------------
# (dst block x src block)-tiled bucketed ELL: the big-graph path
# --------------------------------------------------------------------------

def _bell_block(bell, xs, gather_dtype):
    """One BlockedBELL tile: the f32 [rows_jj, D] partial aggregate over a
    source slice ``xs`` (the per-tier sweeps of ``spmm_bell``, summed in
    f32, no diag)."""
    d = xs.shape[-1]
    xg = xs if gather_dtype is None else xs.to(gather_dtype)
    bytes_per = xg.element_size()
    outs = [_tier_sweep(nb, ws, xg, torch.float32,
                        _tier_chunk(nb, d, bytes_per, cap))
            for nb, ws, cap in zip(bell.nbs, bell.w_slots, bell.caps)]
    outs.append(torch.zeros((1, d), dtype=torch.float32, device=xs.device))
    return torch.cat(outs, dim=0)[bell.outmap.long()]


def _spmm_bbell_raw(bb, x, diag, gather_dtype):
    """out[v] = sum w_uv * x[u] (+ diag term) over a BlockedBELL: each
    tile gathers from one ``block``-row slice of x (cast to
    ``gather_dtype`` once, before slicing), a dst block's tiles add in
    f32, and the result is cast to x's dtype once at the end."""
    n, d = x.shape
    bs, kb = bb.block, bb.kb
    xg = x if gather_dtype is None else x.to(gather_dtype)
    outs = []
    for jj in range(kb):
        acc = torch.zeros((min(bs, n - jj * bs), d), dtype=torch.float32,
                          device=x.device)
        for ii in range(kb):
            bell = bb.tiles[jj * kb + ii]
            if bell is not None:
                acc = acc + _bell_block(bell, xg[ii * bs:(ii + 1) * bs], None)
        outs.append(acc)
    out = torch.cat(outs, dim=0).to(x.dtype)
    if diag is not None:
        out = out + diag[:, None] * x
    return out


class _SpmmBbellSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bb, diag, gather_dtype):
        ctx.bb, ctx.gather_dtype = bb, gather_dtype
        ctx.save_for_backward(diag)
        return _spmm_bbell_raw(bb, x, diag, gather_dtype)

    @staticmethod
    def backward(ctx, ct):
        (diag,) = ctx.saved_tensors
        dx = _spmm_bbell_raw(ctx.bb, ct.contiguous(), diag, ctx.gather_dtype)
        return dx, None, None, None


def spmm_bbell(
    bb,
    x: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    gather_dtype=None,
) -> torch.Tensor:
    """Tiled scatter-free SpMM over a BlockedBELL of a symmetric adjacency
    (static prelaid weights only; a re-weighted graph uses
    ``spmm_blocked``)."""
    return _SpmmBbellSymmetric.apply(x, bb, diag, gather_dtype)


# --------------------------------------------------------------------------
# (dst block x src block)-tiled COO
# --------------------------------------------------------------------------

def _spmm_blocked_raw(blk, w_norm, x, diag, gather_dtype):
    """out[v] = sum w_uv * x[u] (+ diag term) over a BlockedCOO: per tile
    a gather from one ``block``-row slice of x (the last slice padded with
    zero rows) and an f32 index_add into the dst block plus its dummy pad
    row; weights static (``tw``) or re-gathered from ``w_norm`` through the
    tile's edge ids."""
    n, d = x.shape
    bs, kb = blk.block, blk.kb
    xg = x if gather_dtype is None else x.to(gather_dtype)
    if w_norm is not None and blk.te is None:
        raise ValueError(
            "dynamic re-weighting needs per-tile edge ids, but this "
            "BlockedCOO was built with with_edge_ids=False")
    w_ext = (None if w_norm is None
             else torch.cat([w_norm, w_norm.new_zeros(1)]))
    outs = []
    for jj in range(kb):
        acc = torch.zeros((bs + 1, d), dtype=torch.float32, device=x.device)
        for ii in range(kb):
            t = jj * kb + ii
            tw = blk.tw[t] if w_norm is None else w_ext[blk.te[t].long()]
            xs = xg[ii * bs:(ii + 1) * bs]
            if xs.shape[0] < bs:
                xs = torch.cat([xs, xs.new_zeros((bs - xs.shape[0], d))])
            g = xs[blk.sl[t].long()].float() * tw[:, None]
            acc = acc + torch.zeros_like(acc).index_add_(
                0, blk.dl[t].long(), g)
        outs.append(acc[:bs])
    out = torch.cat(outs, dim=0)[:n].to(x.dtype)
    if diag is not None:
        out = out + diag[:, None] * x
    return out


class _SpmmBlockedSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blk, w_norm, diag, gather_dtype):
        ctx.blk, ctx.gather_dtype = blk, gather_dtype
        ctx.save_for_backward(w_norm, diag)
        return _spmm_blocked_raw(blk, w_norm, x, diag, gather_dtype)

    @staticmethod
    def backward(ctx, ct):
        w_norm, diag = ctx.saved_tensors
        dx = _spmm_blocked_raw(ctx.blk, w_norm, ct.contiguous(), diag,
                               ctx.gather_dtype)
        return dx, None, None, None, None


def spmm_blocked(
    blk,
    w_norm: Optional[torch.Tensor],
    x: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    gather_dtype=None,
) -> torch.Tensor:
    """Tiled SpMM over a BlockedCOO of a symmetric adjacency (``w_norm=None``
    uses the static tile weights, otherwise weights re-gather through the
    tiles' edge ids)."""
    return _SpmmBlockedSymmetric.apply(x, blk, w_norm, diag, gather_dtype)


def gcn_propagate(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_w: torch.Tensor,
    x: torch.Tensor,
    num_nodes: int,
    precomputed_norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One GCN aggregation A_hat @ x with normalisation."""
    if precomputed_norm is not None:
        w_norm, diag = precomputed_norm
    else:
        w_norm, diag = gcn_norm_device(edge_src, edge_dst, edge_w, num_nodes)
    return spmm(edge_src, edge_dst, w_norm, x, num_nodes, diag=diag)
