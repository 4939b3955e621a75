"""The tile algorithm of the PE+attention kernels on the CPU, over the
classic table: a test-only mirror of their arithmetic in torch, the
forward's three passes (csrc/pe_attention_fwd_tiles.cuh) and the
backward's kernels (csrc/pe_attention_bwd_tiles.cuh), both on the tile
prologue they share (csrc/pe_attention_tiles.cuh), fed by the slot
compaction the wrappers run (``compact_tagged_slots`` over the column
blocks' classes), held to the plain forward and backward and to the JAX
package's Pallas forward and VJP (interpret mode). The compaction's own
tests, for both tables, and the combined table's mirror tests are in
``test_torch_pe_attention_mixed_tiles.py``.

The mirror walks what the kernels walk: the valid slots compacted in
(class, link, column) order, as a compaction lists them (slots and
offsets); tiles of TS slots of one class, each through one prologue
(``_tile_prologue``): [Ha | Hb] stacked along the reduction axis against
[W2f_k ; W2f_k], each slot's key row (read by id from a ``KeyRows``'
table, or the slot's own row of dense keys) and cbias added, each row's
logit. The forward
writes the logits into a [B*C] scratch at the slot ids, takes each
link's m and l from its row of the scratch under the validity, then runs
the tiles again and sums alpha xj along each link's run of rows in a
tile into out, which starts as the bias. The backward sums dq along each
link's run of rows in a tile; the weight grads per tile; dW2 as a
split-K product over chunks of a class's slots, 64-slot steps cut
smaller here, dxjc read back from the dkeys rows. Small TS here make
tiles cut links' runs and classes end mid-tile.

Tolerance, f32: the mirror and the plain version differ only in
summation order: rtol 1e-4 / atol 1e-5 of each output's scale
(``assert_close_scaled``), as the width tests of the plain op. A link
with no valid slot gets out = bias, m = -5e29 and l = 0 exactly.
"""
import numpy as np
import pytest
import torch

import test_torch_key_rows as key_rows
from test_torch_pe_attention import (
    ALIGNED, DIFF, MISALIGNED, ORDER, _class0_count, _cot, _inputs,
    _jax_fwd, _jax_grads, _torch_args,
)
from test_torch_pe_attention_mixed_bwd import assert_close_scaled

from lpformer_tpu_torch.ops import pe_attention as tpa
from lpformer_tpu_torch.ops import pe_attention_mixed as tpam
from lpformer_tpu_torch.ops.pe_attention_mixed import (
    KeyRows, compact_tagged_slots, key_parts, ln_affine, ln_backward,
)
from lpformer_tpu_torch.utils import measure

NAMES = ("dkeys", "dq", "dw1cat", "dg", "db", "dw2", "dcb", "datt")
EMPTY_M = -5e29
BWD_ORDER = ("keys", "ps", "pt", "valid", "q", "w1", "b1", "g", "b", "w2f",
             "cbias", "att")


def _h(ps, pt, w1, b1, g, b, k, kdt):
    """Both directions' LayerNorm state and h rounded to W2f's type, for
    the slots' (ps, pt)."""
    dirs = [ln_affine(x0, x1, w1[k, 0], w1[k, 1], b1[k], g[k], b[k])
            for x0, x1 in ((ps, pt), (pt, ps))]
    return dirs, [torch.relu(y).to(kdt).float() for _, _, y in dirs]


def slot_keys(keys, slots):
    """The key rows of the slots ``slots``, as the kernels read them: row
    ids[slot] of a ``KeyRows``' table, or row slot of dense [B, C, O]
    keys."""
    table, ids = key_parts(keys)
    rows = slots if ids is None else ids.reshape(-1)[slots].long()
    return table.reshape(-1, table.shape[-1])[rows]


def _runs(links):
    """[start, end) of each run of equal link ids in a tile's rows."""
    cut = [0] + [i for i in range(1, len(links)) if links[i] != links[i - 1]]
    return list(zip(cut, cut[1:] + [len(links)]))


def _tile_prologue(keys, ps, pt, q, w1, b1, g, b, w2f, cbias, att, slots,
                   offsets, ts, stats):
    """The tile prologue of both directions, one tile of <= ts slots of
    class k at a time: yields (k, slot ids, links, PPR values (a0, a1),
    both directions' LayerNorm state, xj [n, O], pre = xj q, z =
    lrelu(pre), s [n]). ``stats`` counts the tiles and the link runs a
    tile boundary cut."""
    k_n, _, dh = w1.shape
    c, o = keys.shape[1:]
    kdt = w2f.dtype
    off = offsets.tolist()
    flat = lambda t: t.reshape(-1)  # noqa: E731
    stats.update(tiles=0, cut_runs=0)
    last = None
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
                 + (slot_keys(keys, ids).float() + cbias[k]))
            pre = x * q[links]
            z = torch.where(pre >= 0, pre, 0.2 * pre)
            yield k, ids, links, (a0, a1), dirs, x, pre, z, (z * att).sum(1)


def mirror_fwd(keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att, bias,
               slots, offsets, ts=8, stats=None):
    """The forward kernels' three passes in torch over the valid slots a
    compaction lists (``slots``, class k's at [offsets[k],
    offsets[k+1])); returns what the plain forward returns, (out, m,
    l)."""
    bsz, c, o = keys.shape
    stats = {} if stats is None else stats
    def tiles():
        return _tile_prologue(keys, ps, pt, q, w1, b1, g, b, w2f, cbias,
                              att, slots, offsets, ts, stats)

    # (i) each valid slot's logit into the scratch at its slot id; the
    # card's scratch is uninitialised, so the dead slots' entries here are
    # NaN and must never be read
    s = torch.full((bsz * c,), float("nan"))
    for _, ids, _, _, _, _, _, _, st in tiles():
        s[ids] = st
    # (ii) per link over its row of the scratch, under the validity
    row = s.reshape(bsz, c)
    m = torch.where(valid, row, torch.tensor(-1e30)).amax(1).clamp_min(-5e29)
    l = torch.where(valid, torch.exp(row - m[:, None]),
                    torch.tensor(0.0)).sum(1)
    out = bias.expand(bsz, o).clone()
    # (iii) the prologue again, alpha xj summed along each link's run
    for _, ids, links, _, _, x, _, _, st in tiles():
        alpha = torch.exp(st - m[links]) / l[links].clamp_min(1e-16)
        for r0, r1 in _runs(links.tolist()):
            out[links[r0]] += (alpha[:, None] * x)[r0:r1].sum(0)
    return out, m, l


def mirror_bwd(keys, ps, pt, q, w1, b1, g, b, w2f, cbias, att, m, l, g_out,
               delta, slots, offsets, ts=8, step=8, nchunk=3, stats=None):
    """The backward tile kernels' algorithm in torch over the valid slots
    a compaction lists (``slots``, class k's at [offsets[k],
    offsets[k+1])); returns what the plain backward returns. ``stats`` (a
    dict) collects the number of tiles and of link runs a tile boundary
    cut."""
    k_n, _, dh = w1.shape
    bsz, c, o = keys.shape
    kdt = w2f.dtype
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

    # the main kernel: one tile of <= ts slots of class k at a time
    for k, ids, links, (a0, a1), dirs, x, pre, z, st in _tile_prologue(
            keys, ps, pt, q, w1, b1, g, b, w2f, cbias, att, slots, offsets,
            ts, stats):
        w = w2f[k].float()
        qb, gb = q[links], g_out[links]
        alpha = torch.exp(st - m[links]) / l[links].clamp_min(1e-16)
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


def classic_slots(valid, widths):
    """The classic wrapper's compaction: (slots, offsets) of
    ``compact_tagged_slots`` over the column blocks' classes."""
    cls = tpa.column_classes(widths, valid.shape[1], valid.device)
    return compact_tagged_slots(valid, cls, len(widths))


def assert_fwd_close(got, want, valid, bias):
    """A forward mirror's (out, m, l) against a reference's at the f32
    tolerance, m on the links with a valid slot (an empty link's -5e29
    would set its scale); the empty links' exact out = bias, m = -5e29
    and l = 0."""
    got, want = [torch.as_tensor(x) for x in got], [torch.as_tensor(np.array(
        x)) for x in want]
    live = torch.as_tensor(valid).any(1)
    for n, x, y in (("out", got[0], want[0]), ("m", got[1][live],
                                               want[1][live]),
                    ("l", got[2], want[2])):
        if y.numel():
            assert_close_scaled(x.numpy(), y.numpy(), 1e-4, 1e-5, n)
    assert bool((got[0][~live] == bias).all())
    assert bool((got[1][~live] == EMPTY_M).all())
    assert bool((got[2][~live] == 0).all())


def classic_mirror(args, widths, **kw):
    """``mirror_bwd`` over ``classic_slots``' list, from the classic plain
    backward's arguments ``args`` (BWD_ORDER, then m, l, g_out, delta)."""
    slots, offsets = classic_slots(args[3], widths)
    return mirror_bwd(*args[:3], *args[4:], slots, offsets, **kw)


def _bwd_args(a, widths):
    """The backward's inputs from the forward inputs ``a`` (numpy): the
    plain forward's m, l and delta for a cotangent from ``_cot``."""
    t = _torch_args(a)
    out, m, l = tpa.fused_pe_link_attention_plain(**t, class_widths=widths)
    g_out = torch.as_tensor(_cot(7, o=out.shape[1]))
    delta = (g_out * (out - t["bias"])).sum(-1)
    return [t[n] for n in BWD_ORDER] + [m, l, g_out, delta]


# (class widths, O, dh, how the validity is drawn)
MIRROR_CASES = {
    "tiles cut runs": (MISALIGNED, 16, 16, "full links"),
    "class count TS": ((12, 40, 20), 16, 16, "count 8"),
    "class count TS+1": ((12, 40, 20), 16, 16, "count 9"),
    "widths 70/36": (MISALIGNED, 70, 36, "full links"),
}
# ... and the forward's: (u, u) links, whose ps and pt are equal (src =
# tgt), and a batch with no valid slot
FWD_MIRROR_CASES = dict(MIRROR_CASES, **{
    "(u, u) links": (MISALIGNED, 16, 16, "u u"),
    "all dead": (MISALIGNED, 16, 16, "all dead"),
})


def _mirror_inputs(case):
    widths, o, dh, draw = FWD_MIRROR_CASES[case]
    a = _inputs(widths, seed=len(case), o=o, dh=dh)
    if draw.startswith("count"):       # class 0 holds exactly n slots
        return _class0_count(a, widths, int(draw.split()[1])), widths
    a["valid"][2, :] = True            # runs longer than a tile
    a["valid"][5, 12:52] = True
    if draw == "all dead":
        a["valid"][:] = False
    for nm in ("ps", "pt"):
        a[nm] = a[nm] * a["valid"]
    if draw == "u u":                  # links 2 and 3: ppr(u, v) twice
        a["pt"][2:4] = a["ps"][2:4]
    return a, widths


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_mirror_matches_plain_f32(case):
    a, widths = _mirror_inputs(case)
    args = _bwd_args(a, widths)
    stats = {}
    got = classic_mirror(args, widths, stats=stats)
    want = tpa.fused_pe_link_attention_bwd_plain(*args, widths)
    draw = MIRROR_CASES[case][3]
    if draw.startswith("count"):       # TS = 8: one full tile, or one more
        _, offsets = classic_slots(args[3], widths)
        assert int(offsets[1]) == int(draw.split()[1])
    else:
        assert stats["cut_runs"] > 0
    for n, x, y in zip(NAMES, got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert_close_scaled(x.numpy(), y.numpy(), 1e-4, 1e-5, n)
    assert bool((got[0][~args[3]] == 0).all())


@pytest.mark.parametrize("case", list(FWD_MIRROR_CASES))
def test_mirror_fwd_matches_plain_f32(case):
    a, widths = _mirror_inputs(case)
    t = _torch_args(a)
    slots, offsets = classic_slots(t["valid"], widths)
    stats = {}
    got = mirror_fwd(*[t[n] for n in ORDER], slots, offsets, stats=stats)
    want = tpa.fused_pe_link_attention_plain(**t, class_widths=widths)
    draw = FWD_MIRROR_CASES[case][3]
    if draw.startswith("count"):       # TS = 8: one full tile, or one more
        assert int(offsets[1]) == int(draw.split()[1])
    elif draw == "all dead":
        assert stats["tiles"] == 0
    else:
        assert stats["cut_runs"] > 0
    assert_fwd_close(got, want, t["valid"], t["bias"])


def test_mirror_fwd_matches_pallas_f32():
    """The forward's tile algorithm against the JAX package's
    class-blocked Pallas forward (interpret mode): out, m and l."""
    a = _inputs(ALIGNED, seed=22)
    t = _torch_args(a)
    slots, offsets = classic_slots(t["valid"], ALIGNED)
    got = mirror_fwd(*[t[n] for n in ORDER], slots, offsets, ts=16)
    assert_fwd_close(got, _jax_fwd(a, ALIGNED), t["valid"], t["bias"])


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
    dkeys, dq, dw1cat, dg, db, dw2, dcb, datt = classic_mirror(
        [t[n] for n in BWD_ORDER] + [m, l, go, delta], ALIGNED, ts=16)
    k = dw1cat.shape[0] // 3
    got = dict(keys=dkeys, q=dq, w1=torch.stack([dw1cat[:k], dw1cat[k:2 * k]],
                                                1),
               b1=dw1cat[2 * k:], g=dg, b=db, w2f=dw2, cbias=dcb, att=datt)
    for n in DIFF[:-1]:
        assert_close_scaled(got[n].numpy(), jg[n], 1e-4, 1e-5, n)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("table", ["combined", "classic"])
def test_tile_mirrors_read_keys_by_id(table, bf16):
    """The kernels' tile mirrors fed by id equal the mirrors fed the
    gathered table, forward and backward, with dead ids N and no pad row;
    in float32 they also hold the plain op fed by id to the mirrors'
    tolerance."""
    a, tab, ids = key_rows._inputs(table, bf16, "pad id", b=12)
    valid = a["valid"]
    if table == "combined":
        slots, offsets = tpam.compact_tagged_slots(valid, a["ecls"], 3)
    else:
        slots, offsets = classic_slots(valid, a["class_widths"])
    fwd = ("ps", "pt", "valid", "q", "w1", "b1", "g", "b", "w2f", "cbias",
           "att", "bias")
    by_id, dense = KeyRows(tab, ids), key_rows._gathered(tab, ids, valid)
    got = mirror_fwd(by_id, *(a[n] for n in fwd), slots, offsets)
    want = mirror_fwd(dense, *(a[n] for n in fwd), slots, offsets)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    plain = key_rows._op(table)(keys=by_id, **a)
    if not bf16:
        assert_fwd_close(got, plain, valid, a["bias"])
    extra = measure.bwd_inputs(dict(a, keys=dense))
    rest = [extra[n] for n in ("q", "w1", "b1", "g", "b", "w2f", "cbias",
                               "att", "m", "l", "g_out", "delta")]
    got_b = mirror_bwd(by_id, a["ps"], a["pt"], *rest, slots, offsets)
    want_b = mirror_bwd(dense, a["ps"], a["pt"], *rest, slots, offsets)
    for x, y in zip(got_b, want_b):
        assert torch.equal(x, y)
