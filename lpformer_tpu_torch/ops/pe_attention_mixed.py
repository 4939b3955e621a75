"""Fused PE + per-link attention over the combined (class-tagged) context
table, forward and backward (counterpart of
``lpformer_tpu/ops/pallas/pe_attention_mixed.py``).

For each link b and each valid slot c, with k = ecls[b, c]:

  g_k(x) = relu(LN_k(x @ W1_k + b1_k)) @ W2f_k       (LN eps 1e-5)
  xj     = keys[b,c] + g_k([ps,pt]) + g_k([pt,ps]) + cbias_k
  s      = sum_o att[o] * leaky_relu_0.2(xj[o] * q[b,o])
  out[b] = sum_c softmax_c(s) xj + bias;  m[b], l[b] the softmax stats

The keys come dense, a [B, C, O] tensor, or by id, as ``KeyRows(table,
ids)``: slot (b, c)'s key is row ids[b, c] of a node table [N', O], which
the kernels read in place, so no [B, C, O] copy of the rows is written
(the model's fused route passes X_node @ W_r[:d] and the context ids).
The op's gradient for the table sums dkeys' valid rows into their ids
(``ops/gather.py:_rows_sum``, the scatter-add kernel on the card).

``fused_pe_link_attention_mixed`` is a ``torch.autograd.Function``. On
CUDA tensors both directions launch hand-written CUDA kernels (built with
nvcc for sm_90a at first use, loaded with ctypes) that take tiles of one
class's valid slots as ``compact_tagged_slots`` lists them (device ops, no
host synchronisation) and share one prologue for each slot's xj and
logit: the forward ``csrc/pe_attention_mixed_fwd.cu``, and the backward
``fused_pe_link_attention_mixed_bwd`` from the saved m, l and out,
``csrc/pe_attention_mixed_bwd.cu``. On CPU tensors they run
``fused_pe_link_attention_mixed_plain`` and
``fused_pe_link_attention_mixed_bwd_plain``, the same math in torch ops
over [B, C]. There is no fallback between kernel and plain version. The
caller side of the backward stays in torch as the JAX package's
``_fused_bwd`` has it: delta = g_out . (out - bias), dbias = sum_b g_out,
and the packed layer-1 grad split back into w1[:, 0], w1[:, 1] and b1.

Rounding points are the TPU kernel's: the hidden activation h is rounded
to W2f's type before the W2f products, the key cotangent dxj before the
dW2f and dh products, and dkeys is in the keys' type. The JAX mixed
backward keeps dW2f in f32 scratch across its whole grid
(lpformer_tpu/ops/pallas/pe_attention_mixed.py:230, :271, :363) and casts
it once (:485); the kernels here sum a class's dW2f in f32 and
``MixedOp.backward`` rounds it once, so the two agree up to the order of
the f32 additions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from lpformer_tpu_torch.ops import gather
from lpformer_tpu_torch.ops._cuda import bind, build_cuda, check_tensors
from lpformer_tpu_torch.ops.segment import masked_softmax

_NEG = -1e30
_LN_EPS = 1e-5
# what both tables' forward kernels include: the forward tile kernels over
# compacted valid slots, the tile prologue they share with the backward
# and the shared device helpers
FWD_HEADERS = ("pe_attention_common.cuh", "pe_attention_tiles.cuh",
               "pe_attention_fwd_tiles.cuh")
# ... and both tables' backward kernels
BWD_HEADERS = ("pe_attention_common.cuh", "pe_attention_tiles.cuh",
               "pe_attention_bwd_tiles.cuh")
_LIB = None
_LIB_BWD = None


def build() -> Tuple[str, str]:
    """Compile the forward kernel (cached by source hash). Returns (library
    path, compiler output, which holds ptxas's register and spill report)."""
    return build_cuda("pe_attention_mixed_fwd", "pe_attention_mixed_fwd.cu",
                      FWD_HEADERS)


def build_bwd() -> Tuple[str, str]:
    """Compile the backward kernels, as :func:`build`."""
    return build_cuda("pe_attention_mixed_bwd", "pe_attention_mixed_bwd.cu",
                      BWD_HEADERS)


def _load():
    global _LIB
    if _LIB is None:
        _LIB = bind(build()[0], "pe_attention_mixed_fwd", 20, 7,
                    "pe_attention_mixed_error_string")
    return _LIB


def _load_bwd():
    global _LIB_BWD
    if _LIB_BWD is None:
        _LIB_BWD = bind(build_bwd()[0], "pe_attention_mixed_bwd", 26, 7,
                        "pe_attention_mixed_bwd_error_string")
    return _LIB_BWD


class KeyRows(NamedTuple):
    """The [B, C, O] key table by id: slot (b, c)'s key is table[ids[b,
    c]]. Both tables' ops take it in place of a dense keys tensor, and
    their kernels read each valid slot's row from ``table`` itself. Dead
    slots' ids are never read and may lie out of range (the context
    tables' pad id N). ``shape``, ``dtype``, ``device`` and
    ``element_size()`` are those of the [B, C, O] tensor it stands for,
    so code that reads them off a keys tensor takes either form."""
    table: torch.Tensor     # [N', O] bf16/f32, N' >= 1
    ids: torch.Tensor       # [B, C] int32

    @property
    def shape(self) -> torch.Size:
        return torch.Size((*self.ids.shape, self.table.shape[-1]))

    @property
    def dtype(self) -> torch.dtype:
        return self.table.dtype

    @property
    def device(self) -> torch.device:
        return self.table.device

    def element_size(self) -> int:
        return self.table.element_size()


def key_parts(keys) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(table, ids) of either form of the keys: a ``KeyRows``' own, or a
    dense [B, C, O] tensor and None (each slot its own row)."""
    if isinstance(keys, KeyRows):
        return keys.table, keys.ids
    return keys, None


def join_keys(table, ids):
    """The keys from ``key_parts``' (table, ids)."""
    return table if ids is None else KeyRows(table, ids)


def dense_keys(keys, valid) -> torch.Tensor:
    """The keys as a [B, C, O] tensor: a dense one as it is; a
    ``KeyRows``' rows gathered, dead slots' rows zero (as the dense route's
    pad row gives them)."""
    table, ids = key_parts(keys)
    if ids is None:
        return keys
    rows = table[torch.where(valid, ids, 0).long()]
    return torch.where(valid[..., None], rows, rows.new_zeros(()))


def table_grad(dkeys, table, ids, valid):
    """The gradient of the keys' source from the op's dkeys [B, C, O]:
    dkeys itself for dense keys; for a ``KeyRows`` table, the valid slots'
    rows summed into their ids in f32 (``ops/gather.py:_rows_sum``, as the
    dense route's gather sums them) and cast once to the table's dtype."""
    if ids is None:
        return dkeys
    return gather._rows_sum(ids, dkeys, table.shape[0], valid).to(
        table.dtype)


def tile_slots(o, dh):
    """Valid slots in one tile of the forward and backward kernels: 64, or
    32 when O or dh passes 128 (a block's shared memory holds the tile's
    [TS, 2 dh] and [TS, max(O, dh)] arrays beside W2f_k)."""
    return 64 if max(o, dh) <= 128 else 32


def compact_tagged_slots(valid, ecls, k):
    """Either table's valid slots in (class, link b, column c) order, as
    both directions' tile kernels take them: (slots [B*C] int32, the slot
    ids b*C + c of the valid slots first, then the dead ones, each in a
    place of its own; offsets [K+1] int32, class k's slots at
    [offsets[k], offsets[k+1])). ``ecls`` holds the classes, per slot
    [B, C] on the combined table, per column [C] on the classic one
    (``pe_attention.column_classes``). A valid slot's class is its ecls
    clamped into [0, K), as the forward kernel reads it; a dead slot's is
    not read. Device ops only, with no host synchronisation: a stable sort
    of the slots by a one-byte key, the class or K for a dead slot (one
    radix pass), and a binary search of the sorted keys for the
    offsets."""
    key = torch.where(valid, ecls.clamp(0, k - 1), k).to(
        torch.uint8).reshape(-1)
    keys, order = torch.sort(key, stable=True)
    bounds = torch.arange(k + 1, dtype=torch.uint8, device=key.device)
    offsets = torch.searchsorted(keys, bounds, out_int32=True)
    return order.int(), offsets


def ln_affine(x0, x1, w1a, w1b, b1, g, b):
    """One PE direction's layer 1 and LayerNorm, on the last axis of the
    broadcast weights: (xhat, r, y) with y = xhat * g + b (before the ReLU)
    and r the rsqrt factor (two-pass statistics, as the reference)."""
    pre = x0[..., None] * w1a + x1[..., None] * w1b + b1
    mu = pre.mean(-1, keepdim=True)
    xc = pre - mu
    var = (xc * xc).mean(-1, keepdim=True)
    r = torch.rsqrt(var + _LN_EPS)
    xhat = xc * r
    return xhat, r, xhat * g + b


def ln_backward(dy, xhat, r, g):
    """The LayerNorm's input cotangent from its output cotangent dy."""
    dxh = dy * g
    return r * (dxh - dxh.mean(-1, keepdim=True)
                - xhat * (dxh * xhat).mean(-1, keepdim=True))


def attend(xj, valid, q, att, bias):
    """GATv2 scores over the keys xj [B, C, O] and the masked softmax
    sum: (out [B, O], m [B], l [B]), as the kernels' online softmax."""
    z = xj * q[:, None, :]
    z = torch.where(z >= 0, z, 0.2 * z)
    s = (z * att.reshape(1, 1, -1)).sum(-1)                  # [B, C]
    masked = torch.where(valid, s, torch.full_like(s, _NEG))
    m = masked.amax(dim=1).clamp_min(_NEG / 2)
    l = (torch.exp(masked - m[:, None]) * valid).sum(dim=1)
    alpha = masked_softmax(s, valid, axis=1)
    out = (alpha[..., None] * xj).sum(dim=1) + bias
    return out, m, l


def attend_backward(xj, valid, q, att, m, l, g_out, delta):
    """The backward of :func:`attend` from the saved m, l and delta =
    g_out . (out - bias): (dxj [B, C, O], dq [B, O], datt [1, O]), f32;
    dead slots' dxj are exactly zero."""
    pre2 = xj * q[:, None, :]
    z = torch.where(pre2 >= 0, pre2, 0.2 * pre2)
    arow = att.reshape(1, 1, -1)
    s = (z * arow).sum(-1)
    masked = torch.where(valid, s, torch.full_like(s, _NEG))
    alpha = (torch.exp(masked - m[:, None]) / l.clamp_min(1e-16)[:, None]
             * valid)
    galpha = (g_out[:, None, :] * xj).sum(-1)
    dlog = alpha * (galpha - delta[:, None])                   # [B, C]
    datt = (dlog[..., None] * z).sum((0, 1)).reshape(att.shape)
    dpre2 = dlog[..., None] * torch.where(pre2 >= 0, 1.0, 0.2) * arow
    dxj = alpha[..., None] * g_out[:, None, :] + dpre2 * q[:, None, :]
    dq = (dpre2 * xj).sum(1)
    return dxj, dq, datt


def fused_pe_link_attention_mixed_plain(
    keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att, bias
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's math in torch ops, as the TPU kernel orders it: each
    direction's hidden activation is rounded to w2f's dtype and multiplied
    by its class's W2f separately. Returns (out [B, O], m [B], l [B])."""
    keys = dense_keys(keys, valid)
    kdt = w2f.dtype
    e = ecls.long()
    w1s, b1s, gs, bs = w1[e], b1[e], g[e], b[e]          # [B, C, (2,) dh]

    def direction(x0, x1):
        _, _, y = ln_affine(x0, x1, w1s[..., 0, :], w1s[..., 1, :], b1s, gs,
                            bs)
        h = torch.relu(y).to(kdt).float()
        pe = torch.zeros(h.shape[:-1] + (w2f.shape[-1],), dtype=torch.float32,
                         device=h.device)
        for k in range(w2f.shape[0]):
            sel = e == k
            pe[sel] = h[sel] @ w2f[k].float()
        return pe

    xj = (keys.float() + direction(ps, pt) + direction(pt, ps)
          + cbias[e])                                        # [B, C, O]
    return attend(xj, valid, q, att, bias)


def key_checks(keys):
    """``check_tensors``' entries for either form of the keys: a dense
    [B, C, O] tensor, or a ``KeyRows``' table [N', O] (at least one row)
    and ids [B, C] int32."""
    table, ids = key_parts(keys)
    bsz, c, o = keys.shape
    if ids is None:
        return {"keys": (table, table.dtype, (bsz, c, o))}
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError("the key table must be [N', O] with N' >= 1, got "
                         f"{tuple(table.shape)}")
    return {"table": (table, table.dtype, (table.shape[0], o)),
            "ids": (ids, torch.int32, (bsz, c))}


def _check(keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att,
           bias=None, **extra):
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
        "ecls": (ecls, torch.int32, (bsz, c)),
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


def _fwd(keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att, bias
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, l): the CUDA kernels on CUDA tensors, the plain version on
    CPU tensors. Counts its calls in
    ``fused_pe_link_attention_mixed.launches``."""
    args = (keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att, bias)
    if keys.device.type == "cpu":
        return fused_pe_link_attention_mixed_plain(*args)
    _check(*args)
    slots, offsets = compact_tagged_slots(valid, ecls, w1.shape[0])
    out = launch_fwd(_load(), "pe_attention_mixed_fwd",
                     "pe_attention_mixed_error_string", keys, ps, pt, valid,
                     slots, offsets, args[5:])
    fused_pe_link_attention_mixed.launches += 1
    return out


def launch_fwd(lib, fn, err_fn, keys, ps, pt, valid, slots, offsets, rest,
               ints=()):
    """Either table's forward kernels: entry ``fn`` of ``lib`` (error text
    from ``err_fn``) on checked inputs (keys dense or by id), the
    compacted slots and ``rest`` = (q, w1, b1, g, b, w2f, cbias, att,
    bias), with ``ints`` after (B, C, O, dh, K). Returns (out, m, l)."""
    bsz, c, o = keys.shape
    k, _, dh = rest[1].shape
    f32 = dict(dtype=torch.float32, device=keys.device)
    s = torch.empty((bsz * c,), **f32)      # each valid slot's logit
    out = torch.empty((bsz, o), **f32)
    m = torch.empty((bsz,), **f32)
    l = torch.empty((bsz,), **f32)
    ptrs = key_ptrs(keys) + [t.data_ptr() for t in (
        ps, pt, valid, slots, offsets, *rest, s, out, m, l)]
    with torch.cuda.device(keys.device):
        err = getattr(lib, fn)(
            *ptrs, bsz, c, o, dh, k, *ints, tile_slots(o, dh),
            int(keys.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + getattr(lib, err_fn)(err).decode())
    return out, m, l


def key_ptrs(keys):
    """The kernels' (keys, ids) pointers: a dense table's and null, or a
    ``KeyRows``' table and ids."""
    table, ids = key_parts(keys)
    return [table.data_ptr(), None if ids is None else ids.data_ptr()]


def fused_pe_link_attention_mixed_bwd_plain(
    keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att, m, l,
    g_out, delta,
):
    """The backward kernel's math in torch ops over [B, C], with the TPU
    kernel's rounding points: each direction's hidden activation hk and
    the key cotangent dxjc are rounded to w2f's dtype, and dw2 = sum
    hk^T dxjc and dh = dxjc W2f^T use the rounded values; everything else
    is f32. Returns (dkeys [B, C, O] keys' dtype, dq [B, O], dw1cat
    [3K, dh] rows (w1a_k | w1b_k | b1_k), dg [K, dh], db [K, dh],
    dw2 [K, dh, O] f32, dcb [K, O], datt [1, O])."""
    keys = dense_keys(keys, valid)
    kdt = w2f.dtype
    k_n, _, dh = w1.shape
    o = keys.shape[-1]
    e = ecls.long()
    w1s, b1s, gs, bs = w1[e], b1[e], g[e], b[e]          # [B, C, (2,) dh]

    def direction(x0, x1):
        xhat, r, y = ln_affine(x0, x1, w1s[..., 0, :], w1s[..., 1, :], b1s,
                               gs, bs)
        return xhat, r, y, torch.relu(y).to(kdt).float()

    xa, ra, ya, ha = direction(ps, pt)
    xb, rb, yb, hb = direction(pt, ps)
    w2 = w2f.float()
    classes = [e == k for k in range(k_n)]
    pe_a = torch.zeros(keys.shape, dtype=torch.float32, device=keys.device)
    pe_b = torch.zeros_like(pe_a)
    for k, sel in enumerate(classes):
        pe_a[sel] = ha[sel] @ w2[k]
        pe_b[sel] = hb[sel] @ w2[k]
    # xj summed in the plain forward's order, so that the plain pair's
    # softmax gradient cancels against its forward's out (as the JAX
    # pair's and the kernel pair's do)
    xj = keys.float() + pe_a + pe_b + cbias[e]                 # [B, C, O]
    dxj, dq, datt = attend_backward(xj, valid, q, att, m, l, g_out, delta)
    dxc = dxj.to(kdt).float()

    def by_class(x):        # sum of [B, C, W] rows per class -> [K, W]
        # a reduction per class: an index_add_ into K rows adds on the
        # card with atomics, f32 chains of up to B * C terms, which at the
        # ppa-like train batch's 400k valid slots read 2e-4 from the f64
        # sums, where the kernel reads 3e-7 (PERF.md section 6)
        return torch.stack([torch.where(sel[..., None], x, 0.0).sum((0, 1))
                            for sel in classes])

    dcb = by_class(dxj)
    dw2 = torch.zeros((k_n, dh, o), dtype=torch.float32, device=keys.device)
    dhh = torch.zeros(ha.shape, dtype=torch.float32, device=keys.device)
    for k, sel in enumerate(classes):
        dxk = dxc[sel]
        dw2[k] = ha[sel].T @ dxk + hb[sel].T @ dxk
        dhh[sel] = dxk @ w2[k].T
    dya = dhh * (ya > 0)
    dyb = dhh * (yb > 0)
    dg = by_class(dya * xa + dyb * xb)
    db = by_class(dya + dyb)

    dpa, dpb = ln_backward(dya, xa, ra, gs), ln_backward(dyb, xb, rb, gs)
    p0, p1 = ps[..., None], pt[..., None]
    dw1cat = torch.cat([by_class(p0 * dpa + p1 * dpb),
                        by_class(p1 * dpa + p0 * dpb),
                        by_class(dpa + dpb)], dim=0)
    return dxj.to(keys.dtype), dq, dw1cat, dg, db, dw2, dcb, datt


def fused_pe_link_attention_mixed_bwd(
    keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att, m, l,
    g_out, delta,
):
    """The backward of the fused op, as the plain version returns it. CUDA
    tensors launch the kernel (``fused_pe_link_attention_mixed_bwd
    .launches`` counts the launches); CPU tensors run the plain version."""
    args = (keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att, m,
            l, g_out, delta)
    if keys.device.type == "cpu":
        return fused_pe_link_attention_mixed_bwd_plain(*args)
    _check(keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att,
           g_out=g_out, m=m, l=l, delta=delta)
    bsz, c, o = keys.shape
    k, _, dh = w1.shape
    dev = keys.device
    f32 = dict(dtype=torch.float32, device=dev)
    # the kernels write the valid slots' rows only (dead rows stay zero)
    # and sum dq with one atomic per run of a link's slots in a tile
    dkeys = torch.zeros(keys.shape, dtype=keys.dtype, device=dev)
    dq = torch.zeros((bsz, o), **f32)
    dw1cat = torch.zeros((3 * k, dh), **f32)
    dg = torch.zeros((k, dh), **f32)
    db = torch.zeros((k, dh), **f32)
    dw2 = torch.zeros((k, dh, o), **f32)
    dcb = torch.zeros((k, o), **f32)
    datt = torch.zeros(att.shape, **f32)
    slots, offsets = compact_tagged_slots(valid, ecls, k)
    lib = _load_bwd()
    with torch.cuda.device(dev):
        err = lib.pe_attention_mixed_bwd(
            *key_ptrs(keys), ps.data_ptr(), pt.data_ptr(), slots.data_ptr(),
            offsets.data_ptr(), q.data_ptr(), g_out.data_ptr(), m.data_ptr(),
            l.data_ptr(), delta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            g.data_ptr(), b.data_ptr(), w2f.data_ptr(), cbias.data_ptr(),
            att.data_ptr(), dkeys.data_ptr(), dq.data_ptr(),
            dw1cat.data_ptr(), dg.data_ptr(), db.data_ptr(), dcb.data_ptr(),
            datt.data_ptr(), dw2.data_ptr(), bsz, c, o, dh, k,
            tile_slots(o, dh), int(keys.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "pe_attention_mixed_bwd launch failed: "
            + lib.pe_attention_mixed_bwd_error_string(err).decode())
    fused_pe_link_attention_mixed_bwd.launches += 1
    return dkeys, dq, dw1cat, dg, db, dw2, dcb, datt


fused_pe_link_attention_mixed_bwd.launches = 0


class MixedOp(torch.autograd.Function):
    """The differentiable op over a (forward, backward) pair of
    implementations: ``fused_pe_link_attention_mixed`` passes the kernel
    wrappers, and the keys as ``key_parts`` splits them (table, ids).
    Returns (out, m, l); m and l carry no gradient."""

    @staticmethod
    def forward(ctx, fwd, bwd, table, ids, ps, pt, valid, ecls, q, w1, b1,
                g, b, w2f, cbias, att, bias):
        keys = join_keys(table, ids)
        out, m, l = fwd(keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f,
                        cbias, att, bias)
        ctx.bwd = bwd
        ctx.save_for_backward(table, ids, ps, pt, valid, ecls, q, w1, b1, g,
                              b, w2f, cbias, att, bias, m, l, out)
        ctx.mark_non_differentiable(m, l)
        return out, m, l

    @staticmethod
    def backward(ctx, g_out, _dm, _dl):
        (table, ids, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att,
         bias, m, l, out) = ctx.saved_tensors
        keys = join_keys(table, ids)
        g_out, delta = backward_cotangent(g_out, out, bias)
        dkeys, dq, dw1cat, dg, db, dw2, dcb, datt = ctx.bwd(
            keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias, att, m,
            l, g_out, delta)
        dw1, db1 = split_layer1_grads(dw1cat)
        return (None, None, table_grad(dkeys, table, ids, valid), None, None,
                None, None, None, dq, dw1, db1, dg, db, dw2.to(w2f.dtype),
                dcb, datt, g_out.sum(0))


def backward_cotangent(g_out, out, bias):
    """The backward kernels' view of the op's output cotangent: (g_out as
    contiguous, 16-byte aligned f32, delta = g_out . (out - bias)), the
    caller side of the JAX package's ``_fused_bwd``."""
    g_out = g_out.float().contiguous()
    if g_out.data_ptr() % 16:      # the kernels read 16-byte vectors
        g_out = g_out.clone()
    return g_out, (g_out * (out - bias)).sum(-1)


def split_layer1_grads(dw1cat):
    """The packed layer-1 grad rows (w1a_k | w1b_k | b1_k) [3K, dh] as
    (dw1 [K, 2, dh], db1 [K, dh])."""
    k = dw1cat.shape[0] // 3
    return torch.stack([dw1cat[:k], dw1cat[k:2 * k]], dim=1), dw1cat[2 * k:]


def fused_pe_link_attention_mixed(
    keys,                  # [B, C, O] bf16/f32 X_node @ W_r[:d] rows:
                           # KeyRows(table, ids), or a dense tensor
    ps: torch.Tensor,      # [B, C] f32 ppr(src, v)
    pt: torch.Tensor,      # [B, C] f32 ppr(tgt, v)
    valid: torch.Tensor,   # [B, C] bool
    ecls: torch.Tensor,    # [B, C] int32 encoder index in [0, K)
    q: torch.Tensor,       # [B, O] f32 lin_l(x_a) + lin_l(x_b)
    w1: torch.Tensor,      # [K, 2, dh] per-class PPR-encoder layer 1
    b1: torch.Tensor,      # [K, dh]
    g: torch.Tensor,       # [K, dh] LayerNorm gain
    b: torch.Tensor,       # [K, dh] LayerNorm bias
    w2f: torch.Tensor,     # [K, dh, O] W2_k @ W_r[d:], keys' dtype
    cbias: torch.Tensor,   # [K, O] 2 * b2_k @ W_r[d:] + lin_r bias
    att: torch.Tensor,     # [1, O]
    bias: torch.Tensor,    # [O]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [B, O] f32, m [B], l [B]), differentiable in every float input
    but ps and pt (whose grads the JAX package returns as zeros): a
    ``KeyRows``' table among them, not its ids. CUDA tensors launch the
    kernels (``.launches`` on this function counts the forward's, on
    ``fused_pe_link_attention_mixed_bwd`` the backward's); CPU tensors
    run the plain versions."""
    return MixedOp.apply(_fwd, fused_pe_link_attention_mixed_bwd,
                         *key_parts(keys), ps, pt, valid, ecls, q, w1, b1, g,
                         b, w2f, cbias, att, bias)


fused_pe_link_attention_mixed.launches = 0
