"""Fused PE + per-link attention over the classic class-blocked context
table, forward and backward (counterpart of
``lpformer_tpu/ops/pallas/pe_attention.py``).

The table's C columns are K contiguous class blocks [cn | 1-hop | >1-hop]
of widths ``class_widths`` (summing to C). For each link b and each valid
slot c of block k:

  g_k(x) = relu(LN_k(x @ W1_k + b1_k)) @ W2f_k       (LN eps 1e-5)
  xj     = keys[b,c] + g_k([ps,pt]) + g_k([pt,ps]) + cbias_k
  s      = sum_o att[o] * leaky_relu_0.2(xj[o] * q[b,o])
  out[b] = sum_c softmax_c(s) xj + bias;  m[b], l[b] the softmax stats

The JAX entry takes ``c_tile`` and ``tile_classes``, a TPU layout: Mosaic's
lane rule makes it carry ps, pt and valid tile-major as [n_tiles, B, tile]
and stack the weights per tile, so every tile must hold one class and one
tile size must divide every width (the JAX package runs its XLA path
otherwise). This op takes ``class_widths`` instead, any widths, keeps the
[B, C] layouts, and stacks only the weights per class ([K, ...], as the
mixed op). No per-slot class tensor is built: the kernels' compaction
keys each slot by its column's block.

The keys come dense or by id (``pe_attention_mixed.KeyRows``: each
valid slot's row read from a node table in place), as the mixed op takes
them.

``fused_pe_link_attention`` is a ``torch.autograd.Function``. On CUDA
tensors both directions launch hand-written CUDA kernels (built with nvcc
for sm_90a at first use, loaded with ctypes), the forward
``csrc/pe_attention_fwd.cu`` and the backward
``fused_pe_link_attention_bwd`` from the saved m, l and out,
``csrc/pe_attention_bwd.cu``: the combined table's tile kernels, which take
tiles of one class's valid slots as ``compact_tagged_slots`` lists them,
here from each column's class block (device ops, no host synchronisation).
On CPU tensors they run ``fused_pe_link_attention_plain`` and
``fused_pe_link_attention_bwd_plain``, the same math in torch ops with one
contiguous column slice per class. There is no fallback between kernel and
plain version. delta = g_out . (out - bias) and dbias = sum_b g_out are
computed in torch, as the JAX package's ``_fused_bwd``.

Rounding points are the TPU kernel's: the hidden activation h is rounded
to the keys' type before the W2f product (pe_attention.py:76-77), the key
cotangent dxj before the dW2f and dh products (:316, :227-228), and dkeys
is in the keys' type (:319). One difference is deliberate: the JAX
backward rounds each C-tile's dW2f to bf16 (:485) and the VJP of
``w2f_cls[sel]`` (:546) then sums a class's tiles, so its bf16 dW2f carries
one rounding per TPU tile; here a class's dW2f is summed in f32 and
rounded once. In f32 the two differ only in summation order.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

from lpformer_tpu_torch.ops._cuda import bind, build_cuda, check_tensors
from lpformer_tpu_torch.ops.pe_attention_mixed import (
    BWD_HEADERS, FWD_HEADERS, attend, attend_backward, backward_cotangent,
    compact_tagged_slots, dense_keys, join_keys, key_checks, key_parts,
    key_ptrs, launch_fwd, ln_affine, ln_backward, split_layer1_grads,
    table_grad, tile_slots,
)
from lpformer_tpu_torch.utils import profiling

_LIB = None
_LIB_BWD = None


def build() -> Tuple[str, str]:
    """Compile the forward kernel (cached by source hash). Returns (library
    path, compiler output, which holds ptxas's register and spill report)."""
    return build_cuda("pe_attention_fwd", "pe_attention_fwd.cu",
                      FWD_HEADERS)


def build_bwd() -> Tuple[str, str]:
    """Compile the backward kernels, as :func:`build`."""
    return build_cuda("pe_attention_bwd", "pe_attention_bwd.cu",
                      BWD_HEADERS)


def _load():
    global _LIB
    if _LIB is None:
        _LIB = bind(build()[0], "pe_attention_fwd", 20, 10,
                    "pe_attention_error_string")
    return _LIB


def _load_bwd():
    global _LIB_BWD
    if _LIB_BWD is None:
        _LIB_BWD = bind(build_bwd()[0], "pe_attention_bwd", 26, 10,
                        "pe_attention_bwd_error_string")
    return _LIB_BWD


def _blocks(class_widths):
    """(class index, column slice) of each class block."""
    lo = 0
    for k, w in enumerate(class_widths):
        yield k, slice(lo, lo + w)
        lo += w


def _check_widths(class_widths, k, c):
    if (len(class_widths) != k or any(w < 0 for w in class_widths)
            or sum(class_widths) != c):
        raise ValueError(f"class_widths {tuple(class_widths)} must be {k} "
                         f"non-negative widths summing to C={c}")


def _pe_blocks(ps, pt, w1, b1, g, b, w2f, class_widths):
    """Per class block: both directions' (xhat, r, y, h rounded to w2f's
    dtype) and their W2f products (pe_a, pe_b), each [B, w_k, ...]."""
    kdt = w2f.dtype
    out = []
    for k, cols in _blocks(class_widths):
        w2 = w2f[k].float()
        dirs = []
        for x0, x1 in ((ps[:, cols], pt[:, cols]), (pt[:, cols], ps[:, cols])):
            xhat, r, y = ln_affine(x0, x1, w1[k, 0], w1[k, 1], b1[k], g[k],
                                   b[k])
            dirs.append((xhat, r, y, torch.relu(y).to(kdt).float()))
        out.append((dirs, dirs[0][3] @ w2, dirs[1][3] @ w2))
    return out


def column_classes(class_widths, c, device):
    """[C] int32: each column's class, the index of its block, for
    ``compact_tagged_slots``. Built from Python ints by device ops, so no
    tensor crosses from the host."""
    col = torch.arange(c, dtype=torch.int32, device=device)
    cls = torch.zeros_like(col)
    for end in itertools.accumulate(class_widths[:-1]):
        cls += col >= end
    return cls


def _keys_xj(keys, cbias, blocks, class_widths):
    """xj = keys + pe_a + pe_b + cbias_k, summed in the TPU kernel's
    order."""
    cat = lambda j: torch.cat([blk[j] for blk in blocks], dim=1)  # noqa: E731
    cb = torch.cat([cbias[k].expand(cols.stop - cols.start, -1)
                    for k, cols in _blocks(class_widths)], dim=0)  # [C, O]
    return keys.float() + cat(1) + cat(2) + cb


def fused_pe_link_attention_plain(
    keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, bias,
    class_widths,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's math in torch ops, one contiguous column slice per
    class: each direction's hidden activation is rounded to w2f's dtype
    and multiplied by its class's W2f separately. Returns (out [B, O],
    m [B], l [B])."""
    keys = dense_keys(keys, valid)
    blocks = _pe_blocks(ps, pt, w1, b1, g, b, w2f, class_widths)
    xj = _keys_xj(keys, cbias, blocks, class_widths)             # [B, C, O]
    return attend(xj, valid, q, att, bias)


def fused_pe_link_attention_bwd_plain(
    keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, m, l, g_out,
    delta, class_widths,
):
    """The backward kernels' math in torch ops, one column slice per class,
    with the TPU kernel's rounding points: each direction's hidden
    activation hk and the key cotangent dxjc are rounded to w2f's dtype,
    and dw2 = sum hk^T dxjc and dh = dxjc W2f^T use the rounded values;
    everything else is f32. Returns (dkeys [B, C, O] keys' dtype, dq
    [B, O], dw1cat [3K, dh] rows (w1a_k | w1b_k | b1_k), dg [K, dh],
    db [K, dh], dw2 [K, dh, O] f32, dcb [K, O], datt [1, O])."""
    keys = dense_keys(keys, valid)
    k_n, _, dh = w1.shape
    o = keys.shape[-1]
    blocks = _pe_blocks(ps, pt, w1, b1, g, b, w2f, class_widths)
    xj = _keys_xj(keys, cbias, blocks, class_widths)
    dxj, dq, datt = attend_backward(xj, valid, q, att, m, l, g_out, delta)
    dxc = dxj.to(w2f.dtype).float()
    f32 = dict(dtype=torch.float32, device=keys.device)
    dw1cat = torch.zeros((3 * k_n, dh), **f32)
    dg, db = torch.zeros((k_n, dh), **f32), torch.zeros((k_n, dh), **f32)
    dw2 = torch.zeros((k_n, dh, o), **f32)
    dcb = torch.zeros((k_n, o), **f32)
    for (k, cols), (dirs, _, _) in zip(_blocks(class_widths), blocks):
        (xa, ra, ya, ha), (xb, rb, yb, hb) = dirs
        dx = dxc[:, cols].reshape(-1, o)                         # [B*w, O]
        dcb[k] = dxj[:, cols].sum((0, 1))
        dw2[k] = ha.reshape(-1, dh).T @ dx + hb.reshape(-1, dh).T @ dx
        dhh = (dx @ w2f[k].float().T).reshape(ha.shape)
        dya, dyb = dhh * (ya > 0), dhh * (yb > 0)
        dg[k] = (dya * xa + dyb * xb).sum((0, 1))
        db[k] = (dya + dyb).sum((0, 1))
        dpa = ln_backward(dya, xa, ra, g[k])
        dpb = ln_backward(dyb, xb, rb, g[k])
        p0, p1 = ps[:, cols, None], pt[:, cols, None]
        dw1cat[k] = (p0 * dpa + p1 * dpb).sum((0, 1))
        dw1cat[k_n + k] = (p1 * dpa + p0 * dpb).sum((0, 1))
        dw1cat[2 * k_n + k] = (dpa + dpb).sum((0, 1))
    return dxj.to(keys.dtype), dq, dw1cat, dg, db, dw2, dcb, datt


def _check(keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, bias=None,
           **extra):
    """Dtypes, shapes, devices, contiguity and alignment the kernels take;
    ``bias`` is the forward's, ``extra`` holds the backward's further f32
    inputs by name (g_out [B, O], m, l, delta [B])."""
    bsz, c, o = keys.shape
    k, _, dh = w1.shape
    per_link = {"g_out": (bsz, o), "m": (bsz,), "l": (bsz,),
                "delta": (bsz,)}
    want = {
        **key_checks(keys),
        "ps": (ps, torch.float32, (bsz, c)),
        "pt": (pt, torch.float32, (bsz, c)),
        "valid": (valid, torch.bool, (bsz, c)),
        "q": (q, torch.float32, (bsz, o)),
        "w1": (w1, torch.float32, (k, 2, dh)),
        "b1": (b1, torch.float32, (k, dh)),
        "g": (g, torch.float32, (k, dh)),
        "b": (b, torch.float32, (k, dh)),
        "w2f": (w2f, keys.dtype, (k, dh, o)),
        "cbias": (cbias, torch.float32, (k, o)),
        "att": (att, torch.float32, (1, o)),
    }
    if bias is not None:
        want["bias"] = (bias, torch.float32, (o,))
    for name, t in extra.items():
        want[name] = (t, torch.float32, per_link[name])
    if k > 3:
        raise ValueError(f"the kernels take K <= 3 classes, got {k}")
    check_tensors(keys, want)


def _widths3(class_widths):
    return list(class_widths) + [0] * (3 - len(class_widths))


def _fwd(keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, bias,
         class_widths) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, l): the CUDA kernels on CUDA tensors, the plain version on
    CPU tensors. Counts its calls in ``fused_pe_link_attention.launches``."""
    args = (keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, bias)
    if keys.device.type == "cpu":
        return fused_pe_link_attention_plain(*args, class_widths)
    _check(*args)
    c, k = keys.shape[1], w1.shape[0]
    slots, offsets = compact_tagged_slots(
        valid, column_classes(class_widths, c, keys.device), k)
    out = launch_fwd(_load(), "pe_attention_fwd", "pe_attention_error_string",
                     keys, ps, pt, valid, slots, offsets, args[4:],
                     _widths3(class_widths))
    fused_pe_link_attention.launches += 1
    return out


def fused_pe_link_attention_bwd(
    keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, m, l, g_out,
    delta, class_widths,
):
    """The backward of the fused op, as the plain version returns it. CUDA
    tensors launch the kernels (``fused_pe_link_attention_bwd.launches``
    counts the calls); CPU tensors run the plain version."""
    args = (keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, m, l,
            g_out, delta)
    if keys.device.type == "cpu":
        return fused_pe_link_attention_bwd_plain(*args, class_widths)
    _check(keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att,
           g_out=g_out, m=m, l=l, delta=delta)
    bsz, c, o = keys.shape
    k, _, dh = w1.shape
    dev = keys.device
    f32 = dict(dtype=torch.float32, device=dev)
    # the kernels write the valid slots' rows only: dead rows stay zero
    dkeys = torch.zeros(keys.shape, dtype=keys.dtype, device=dev)
    dq = torch.zeros((bsz, o), **f32)
    dw1cat = torch.zeros((3 * k, dh), **f32)
    dg = torch.zeros((k, dh), **f32)
    db = torch.zeros((k, dh), **f32)
    dw2 = torch.zeros((k, dh, o), **f32)
    dcb = torch.zeros((k, o), **f32)
    datt = torch.zeros(att.shape, **f32)
    slots, offsets = compact_tagged_slots(
        valid, column_classes(class_widths, c, dev), k)
    lib = _load_bwd()
    with torch.cuda.device(dev):
        err = lib.pe_attention_bwd(
            *key_ptrs(keys), ps.data_ptr(), pt.data_ptr(),
            slots.data_ptr(), offsets.data_ptr(),
            q.data_ptr(), g_out.data_ptr(), m.data_ptr(), l.data_ptr(),
            delta.data_ptr(), w1.data_ptr(), b1.data_ptr(), g.data_ptr(),
            b.data_ptr(), w2f.data_ptr(), cbias.data_ptr(), att.data_ptr(),
            dkeys.data_ptr(), dq.data_ptr(), dw1cat.data_ptr(),
            dg.data_ptr(), db.data_ptr(), dcb.data_ptr(), datt.data_ptr(),
            dw2.data_ptr(), bsz, c, o, dh, k,
            *_widths3(class_widths), tile_slots(o, dh),
            int(keys.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("pe_attention_bwd launch failed: "
                           + lib.pe_attention_bwd_error_string(err).decode())
    fused_pe_link_attention_bwd.launches += 1
    return dkeys, dq, dw1cat, dg, db, dw2, dcb, datt


fused_pe_link_attention_bwd.launches = 0


class BlockedOp(torch.autograd.Function):
    """The differentiable op over a (forward, backward) pair of
    implementations: ``fused_pe_link_attention`` passes the kernel
    wrappers, and the keys as ``key_parts`` splits them (table, ids).
    Returns (out, m, l); m and l carry no gradient."""

    @staticmethod
    def forward(ctx, fwd, bwd, class_widths, table, ids, ps, pt, valid, q,
                w1, b1, g, b, w2f, cbias, att, bias):
        keys = join_keys(table, ids)
        out, m, l = fwd(keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias,
                        att, bias, class_widths)
        ctx.bwd, ctx.class_widths = bwd, class_widths
        ctx.save_for_backward(table, ids, ps, pt, valid, q, w1, b1, g, b, w2f,
                              cbias, att, bias, m, l, out)
        ctx.mark_non_differentiable(m, l)
        return out, m, l

    @staticmethod
    def backward(ctx, g_out, _dm, _dl):
        (table, ids, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, bias,
         m, l, out) = ctx.saved_tensors
        keys = join_keys(table, ids)
        with profiling.span("model.pe_attention.bwd"):
            g_out, delta = backward_cotangent(g_out, out, bias)
            dkeys, dq, dw1cat, dg, db, dw2, dcb, datt = ctx.bwd(
                keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, m, l,
                g_out, delta, ctx.class_widths)
            dw1, db1 = split_layer1_grads(dw1cat)
            dtable = table_grad(dkeys, table, ids, valid)
        return (None, None, None, dtable, None, None, None, None, dq, dw1,
                db1, dg, db, dw2.to(w2f.dtype), dcb, datt, g_out.sum(0))


def fused_pe_link_attention(
    keys,                  # [B, C, O] bf16/f32 X_node @ W_r[:d] rows:
                           # KeyRows(table, ids), or a dense tensor
    ps: torch.Tensor,      # [B, C] f32 ppr(src, v)
    pt: torch.Tensor,      # [B, C] f32 ppr(tgt, v)
    valid: torch.Tensor,   # [B, C] bool
    q: torch.Tensor,       # [B, O] f32 lin_l(x_a) + lin_l(x_b)
    w1: torch.Tensor,      # [K, 2, dh] per-class PPR-encoder layer 1
    b1: torch.Tensor,      # [K, dh]
    g: torch.Tensor,       # [K, dh] LayerNorm gain
    b: torch.Tensor,       # [K, dh] LayerNorm bias
    w2f: torch.Tensor,     # [K, dh, O] W2_k @ W_r[d:], keys' dtype
    cbias: torch.Tensor,   # [K, O] 2 * b2_k @ W_r[d:] + lin_r bias
    att: torch.Tensor,     # [1, O]
    bias: torch.Tensor,    # [O]
    class_widths: Sequence[int],   # K column counts summing to C
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [B, O] f32, m [B], l [B]), differentiable in every float input
    but ps and pt (whose grads the JAX package returns as zeros): a
    ``KeyRows``' table among them, not its ids. CUDA tensors launch the
    kernels (``.launches`` on this function counts the forward's, on
    ``fused_pe_link_attention_bwd`` the backward's); CPU tensors run the
    plain versions."""
    class_widths = tuple(int(w) for w in class_widths)
    _check_widths(class_widths, w1.shape[0], keys.shape[1])
    return BlockedOp.apply(_fwd, fused_pe_link_attention_bwd, class_widths,
                           *key_parts(keys), ps, pt, valid, q, w1, b1, g, b,
                           w2f, cbias, att, bias)


fused_pe_link_attention.launches = 0
