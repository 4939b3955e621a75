"""The classic-table backward's tile algorithm (csrc/pe_attention_bwd_tiles.cuh)
on the CPU: the slot compaction its wrapper runs, and a test-only mirror of
its kernels' arithmetic in torch, held to the plain backward and to the
JAX package's Pallas VJP (interpret mode).

The mirror walks what the kernels walk: the valid slots compacted in
(class, link, column) order; tiles of TS slots of one class; [Ha | Hb]
stacked along the reduction axis against [W2f_k ; W2f_k]; dq summed along
each link's run of rows in a tile; the weight grads summed per tile; dW2
as a split-K product over chunks of a class's slots, 64-slot steps cut
smaller here, dxjc read back from the dkeys rows. Small TS here make
tiles cut links' runs and classes end mid-tile.

Tolerance, f32: the mirror and the plain version differ only in
summation order: rtol 1e-4 / atol 1e-5 of each output's scale
(``assert_close_scaled``), as the width tests of the plain op.
"""
import numpy as np
import pytest
import torch

from test_torch_pe_attention import (
    ALIGNED, DIFF, MISALIGNED, _class0_count, _cot, _inputs, _jax_fwd,
    _jax_grads, _torch_args,
)
from test_torch_pe_attention_mixed_bwd import assert_close_scaled

from lpformer_tpu_torch.ops import pe_attention as tpa
from lpformer_tpu_torch.ops.pe_attention_mixed import ln_affine, ln_backward

NAMES = ("dkeys", "dq", "dw1cat", "dg", "db", "dw2", "dcb", "datt")
BWD_ORDER = ("keys", "ps", "pt", "valid", "q", "w1", "b1", "g", "b", "w2f",
             "cbias", "att")


def _h(ps, pt, w1, b1, g, b, k, kdt):
    """Both directions' LayerNorm state and h rounded to W2f's type, for
    the slots' (ps, pt)."""
    dirs = [ln_affine(x0, x1, w1[k, 0], w1[k, 1], b1[k], g[k], b[k])
            for x0, x1 in ((ps, pt), (pt, ps))]
    return dirs, [torch.relu(y).to(kdt).float() for _, _, y in dirs]


def _runs(links):
    """[start, end) of each run of equal link ids in a tile's rows."""
    cut = [0] + [i for i in range(1, len(links)) if links[i] != links[i - 1]]
    return list(zip(cut, cut[1:] + [len(links)]))


def mirror_bwd(keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, m, l,
               g_out, delta, class_widths, ts=8, step=8, nchunk=3,
               stats=None):
    """The tile kernels' algorithm in torch; returns what the plain backward
    returns. ``stats`` (a dict) collects the number of tiles and of link
    runs a tile boundary cut."""
    k_n, _, dh = w1.shape
    bsz, c, o = keys.shape
    kdt = w2f.dtype
    slots, offsets = tpa.compact_slots(valid, class_widths)
    off = offsets.tolist()
    f32 = dict(dtype=torch.float32)
    dkeys = torch.zeros(keys.shape, dtype=keys.dtype).reshape(-1, o)
    dq = torch.zeros((bsz, o), **f32)
    dw1cat = torch.zeros((3 * k_n, dh), **f32)
    dg, db = torch.zeros((k_n, dh), **f32), torch.zeros((k_n, dh), **f32)
    dw2 = torch.zeros((k_n, dh, o), **f32)
    dcb = torch.zeros((k_n, o), **f32)
    datt = torch.zeros(att.shape, **f32)
    flat = lambda t: t.reshape(-1)  # noqa: E731
    stats = {} if stats is None else stats
    stats.update(tiles=0, cut_runs=0)
    last = None

    # the main kernel: one tile of <= ts slots of class k at a time
    for k in range(k_n):
        w = w2f[k].float()
        for s0 in range(off[k], off[k + 1], ts):
            ids = slots[s0:min(s0 + ts, off[k + 1])].long()
            links = ids // c
            a0, a1 = flat(ps)[ids], flat(pt)[ids]
            dirs, (ha, hb) = _h(a0, a1, w1, b1, g, b, k, kdt)
            stats["tiles"] += 1
            stats["cut_runs"] += int(last is not None and
                                     int(links[0]) == last)
            last = int(links[-1])
            # [Ha | Hb] [W ; W]: each direction's rounded h multiplied
            x = (torch.cat([ha, hb], 1) @ torch.cat([w, w], 0)
                 + (keys.reshape(-1, o)[ids].float() + cbias[k]))
            qb, gb = q[links], g_out[links]
            pre = x * qb
            z = torch.where(pre >= 0, pre, 0.2 * pre)
            alpha = (torch.exp((z * att).sum(1) - m[links])
                     / l[links].clamp_min(1e-16))
            dlog = alpha * ((gb * x).sum(1) - delta[links])
            dpre = dlog[:, None] * att * torch.where(pre >= 0, 1.0, 0.2)
            dxj = alpha[:, None] * gb + dpre * qb
            dkeys[ids] = dxj.to(keys.dtype)
            for r0, r1 in _runs(links.tolist()):
                dq[links[r0]] += (dpre * x)[r0:r1].sum(0)
            dcb[k] += dxj.sum(0)
            datt += (dlog[:, None] * z).sum(0)
            dh_ = dxj.to(kdt).float() @ w.T
            (xa, ra, ya), (xb, rb, yb) = dirs
            dya, dyb = dh_ * (ya > 0), dh_ * (yb > 0)
            dg[k] += (dya * xa + dyb * xb).sum(0)
            db[k] += (dya + dyb).sum(0)
            dpa, dpb = ln_backward(dya, xa, ra, g[k]), ln_backward(
                dyb, xb, rb, g[k])
            p0, p1 = a0[:, None], a1[:, None]
            dw1cat[k] += (p0 * dpa + p1 * dpb).sum(0)
            dw1cat[k_n + k] += (p1 * dpa + p0 * dpb).sum(0)
            dw1cat[2 * k_n + k] += (dpa + dpb).sum(0)

    # the dw2 kernel: split K over nchunk chunks of class k's slots, each
    # in steps of `step` slots, dxjc read back from dkeys
    for k in range(k_n):
        cnt = off[k + 1] - off[k]
        per = -(-(-(-cnt // nchunk)) // step) * step
        for j in range(nchunk):
            lo = off[k] + j * per
            part = torch.zeros((dh, o), **f32)
            for s0 in range(lo, min(off[k + 1], lo + per), step):
                ids = slots[s0:min(s0 + step, off[k + 1], lo + per)].long()
                _, (ha, hb) = _h(flat(ps)[ids], flat(pt)[ids], w1, b1, g, b,
                                 k, kdt)
                dxc = dkeys[ids].float()
                part += ha.T @ dxc + hb.T @ dxc
            dw2[k] += part
    return dkeys.reshape(keys.shape), dq, dw1cat, dg, db, dw2, dcb, datt


def _bwd_args(a, widths):
    """The backward's inputs from the forward inputs ``a`` (numpy): the
    plain forward's m, l and delta for a cotangent from ``_cot``."""
    t = _torch_args(a)
    out, m, l = tpa.fused_pe_link_attention_plain(**t, class_widths=widths)
    g_out = torch.as_tensor(_cot(7, o=out.shape[1]))
    delta = (g_out * (out - t["bias"])).sum(-1)
    return [t[n] for n in BWD_ORDER] + [m, l, g_out, delta]


@pytest.mark.parametrize("widths,case", [
    (MISALIGNED, "random"), ((0, 40, 20), "empty class"),
    ((12, 40, 20), "full block"), ((12, 40, 20), "all dead")])
def test_compact_slots_orders_by_class_link_column(widths, case):
    rng = np.random.default_rng(len(case))
    valid = torch.as_tensor(rng.random((8, sum(widths))) < 0.4)
    if case == "full block":
        valid[3, 12:52] = True
    if case == "all dead":
        valid[:] = False
    slots, offsets = tpa.compact_slots(valid, widths)
    assert slots.dtype == offsets.dtype == torch.int32
    assert slots.shape == (valid.numel(),)
    want, counts, lo = [], [0], 0
    for w in widths:
        nz = valid[:, lo:lo + w].nonzero()          # (b, c) row-major
        want += (nz[:, 0] * valid.shape[1] + lo + nz[:, 1]).tolist()
        counts.append(counts[-1] + len(nz))
        lo += w
    assert offsets.tolist() == counts
    assert slots[:len(want)].tolist() == want


# (class widths, O, dh, how the validity is drawn)
MIRROR_CASES = {
    "tiles cut runs": (MISALIGNED, 16, 16, "full links"),
    "class count TS": ((12, 40, 20), 16, 16, "count 8"),
    "class count TS+1": ((12, 40, 20), 16, 16, "count 9"),
    "widths 70/36": (MISALIGNED, 70, 36, "full links"),
}


def _mirror_inputs(case):
    widths, o, dh, draw = MIRROR_CASES[case]
    a = _inputs(widths, seed=len(case), o=o, dh=dh)
    if draw != "full links":           # class 0 holds exactly n slots
        return _class0_count(a, widths, int(draw.split()[1])), widths
    a["valid"][2, :] = True            # runs longer than a tile
    a["valid"][5, 12:52] = True
    for nm in ("ps", "pt"):
        a[nm] = a[nm] * a["valid"]
    return a, widths


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_mirror_matches_plain_f32(case):
    a, widths = _mirror_inputs(case)
    args = _bwd_args(a, widths)
    stats = {}
    got = mirror_bwd(*args, widths, stats=stats)
    want = tpa.fused_pe_link_attention_bwd_plain(*args, widths)
    draw = MIRROR_CASES[case][3]
    if draw.startswith("count"):       # TS = 8: one full tile, or one more
        _, offsets = tpa.compact_slots(args[3], widths)
        assert int(offsets[1]) == int(draw.split()[1])
    else:
        assert stats["cut_runs"] > 0
    for n, x, y in zip(NAMES, got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert_close_scaled(x.numpy(), y.numpy(), 1e-4, 1e-5, n)
    assert bool((got[0][~args[3]] == 0).all())


def test_mirror_matches_pallas_vjp_f32():
    """The tile algorithm against the JAX package's class-blocked Pallas
    backward (interpret mode): its grads of keys, q and every weight."""
    a = _inputs(ALIGNED, seed=21)
    g_out = _cot(21)
    _, jg = _jax_grads(a, ALIGNED, g_out)
    out, m, l = _jax_fwd(a, ALIGNED)
    t = _torch_args(a)
    go = torch.as_tensor(g_out)
    m, l = torch.as_tensor(np.array(m)), torch.as_tensor(np.array(l))
    delta = (go * (torch.as_tensor(np.array(out)) - t["bias"])).sum(-1)
    dkeys, dq, dw1cat, dg, db, dw2, dcb, datt = mirror_bwd(
        *(t[n] for n in BWD_ORDER), m, l, go, delta, ALIGNED, ts=16)
    k = dw1cat.shape[0] // 3
    got = dict(keys=dkeys, q=dq, w1=torch.stack([dw1cat[:k], dw1cat[k:2 * k]],
                                                1),
               b1=dw1cat[2 * k:], g=dg, b=db, w2f=dw2, cbias=dcb, att=datt)
    for n in DIFF[:-1]:
        assert_close_scaled(got[n].numpy(), jg[n], 1e-4, 1e-5, n)
