"""The combined table's forward and backward on the tile kernels
(csrc/pe_attention_{fwd,bwd}_tiles.cuh, through
csrc/pe_attention_mixed_{fwd,bwd}.cu): the slot compaction both tables'
wrappers run, ``compact_tagged_slots``, against a numpy reference (the
combined table's tags and the classic table's column blocks), and the
tile mirrors of ``test_torch_pe_attention_tiles.py`` fed by the combined
table's slots, held to the plain forward and backward
(``fused_pe_link_attention_mixed_plain``, ``..._bwd_plain``) and to the
JAX package's mixed Pallas forward and VJP (interpret mode). On the card
(``cuda`` marker) the backward kernels are held to the plain backward,
and both tables' wrappers, forward and backward, are run at the main
shape under ``set_sync_debug_mode("error")``.

A link's valid slots of the combined table mix their classes, so the
compaction splits a link into up to K runs, one per class; small tiles in
the mirror (TS = 8, or 4) also cut runs and end classes mid-tile.

Tolerances. Compaction: exact. Mirror, f32: it differs from the plain
version and the Pallas VJP only in summation order: rtol 1e-4 / atol 1e-5
of each output's scale (``assert_close_scaled``). Card, bf16: the
backward tolerance of ``test_torch_pe_attention_mixed_bwd.py`` (2e-2 of
max and 2e-3 of mean magnitude; a flipped bf16 rounding of h or dxjc).
"""
import numpy as np
import pytest
import torch
from test_torch_pe_attention_mixed import _inputs, _jax, _torch_args
from test_torch_pe_attention_mixed_bwd import (
    DIFF, _cot, _jax_grads, assert_close_card, assert_close_scaled,
)
from test_torch_pe_attention_tiles import (
    NAMES, assert_fwd_close, mirror_bwd, mirror_fwd,
)

from lpformer_tpu_torch.ops import pe_attention as tpa
from lpformer_tpu_torch.ops import pe_attention_mixed as tpam

K = 3
ORDER = ("keys", "ps", "pt", "valid", "ecls", "q", "w1", "b1", "g", "b",
         "w2f", "cbias", "att")
# the forward mirror's arguments: no class source, the bias last
FWD_ORDER = tuple(n for n in ORDER if n != "ecls") + ("bias",)


def _reference(valid, ecls, k):
    """(slot ids of the valid slots in (class, link, column) order, class
    offsets), by loops in numpy."""
    cls = np.clip(ecls, 0, k - 1)
    want, offsets = [], [0]
    for kk in range(k):
        want += [i for i in range(valid.size)
                 if valid.flat[i] and cls.flat[i] == kk]
        offsets.append(len(want))
    return want, offsets


# (table, case): the combined table's classes are per-slot tags, the
# classic table's its column blocks (ops/pe_attention.py:column_classes)
COMPACT_CASES = ([("combined", c) for c in (
    "random", "empty class", "all dead", "one class link",
    "dead slots tagged", "out of range")]
    + [("classic", c) for c in (
        "random", "empty class", "full block", "all dead")])


def _compact_case(table, case):
    """(valid [B, C] numpy, the classes the compaction is given, the
    classes per slot in numpy for the reference)."""
    rng = np.random.default_rng(len(case))
    if table == "classic":
        widths = (0, 40, 20) if case == "empty class" else (12, 40, 20)
        valid = rng.random((8, sum(widths))) < 0.4
        if case == "full block":        # a run longer than any tile
            valid[3, 12:52] = True
        if case == "all dead":
            valid[:] = False
        want_cls = np.repeat(np.arange(K), widths)
        cls = tpa.column_classes(widths, valid.shape[1], "cpu")
        assert cls.dtype == torch.int32
        assert cls.tolist() == want_cls.tolist()
        return valid, cls, np.broadcast_to(want_cls, valid.shape)
    b, c = 8, 40
    valid = rng.random((b, c)) < 0.4
    ecls = rng.integers(0, K, (b, c))
    if case == "empty class":
        ecls = np.where(ecls == 1, 2, ecls)
    if case == "all dead":
        valid[:] = False
    if case == "one class link":     # a run longer than any tile
        valid[3] = True
        ecls[3] = 2
    # dead slots' tags are not read; the model sets them to 0
    ecls = np.where(valid, ecls, 0 if case == "random" else
                    rng.integers(1, K, (b, c)))
    if case == "out of range":       # clamped into [0, K) as the forward
        ecls = np.where(rng.random((b, c)) < 0.5, ecls,
                        rng.choice([-3, -1, K, K + 4], (b, c)))
    return valid, torch.as_tensor(ecls, dtype=torch.int32), ecls


@pytest.mark.parametrize("table,case", COMPACT_CASES)
def test_compact_tagged_slots_orders_by_class_link_column(table, case):
    valid, cls, ref_cls = _compact_case(table, case)
    b, c = valid.shape
    slots, offsets = tpam.compact_tagged_slots(torch.as_tensor(valid), cls,
                                               K)
    assert slots.dtype == offsets.dtype == torch.int32
    assert slots.shape == (b * c,) and offsets.shape == (K + 1,)
    want, want_off = _reference(valid, ref_cls, K)
    assert offsets.tolist() == want_off
    assert slots[:len(want)].tolist() == want
    # every slot in a place of its own: the dead ones follow, in order
    dead = np.flatnonzero(~valid.reshape(-1)).tolist()
    assert slots[len(want):].tolist() == dead
    if case == "empty class":
        empty = 0 if table == "classic" else 1
        assert want_off[empty] == want_off[empty + 1]


def _draw(valid, ecls, seed, o=16, dh=16, bf16=False):
    """Inputs of the mixed op around a validity and class layout (numpy)."""
    rng = np.random.default_rng(seed)
    b, c = valid.shape
    a = dict(
        keys=rng.standard_normal((b, c, o)).astype(np.float32) * 0.5,
        ps=(rng.random((b, c)) * 0.1).astype(np.float32) * valid,
        pt=(rng.random((b, c)) * 0.1).astype(np.float32) * valid,
        valid=valid, ecls=ecls.astype(np.int32),
        q=rng.standard_normal((b, o)).astype(np.float32),
        w1=rng.standard_normal((K, 2, dh)).astype(np.float32),
        b1=rng.standard_normal((K, dh)).astype(np.float32) * 0.1,
        g=(1 + 0.1 * rng.standard_normal((K, dh))).astype(np.float32),
        b=(0.1 * rng.standard_normal((K, dh))).astype(np.float32),
        w2f=(rng.standard_normal((K, dh, o)) / dh ** 0.5).astype(np.float32),
        cbias=(0.1 * rng.standard_normal((K, o))).astype(np.float32),
        att=rng.standard_normal((1, o)).astype(np.float32) * 0.3,
        bias=(0.1 * rng.standard_normal(o)).astype(np.float32),
    )
    if bf16:  # round once, so both sides see the same values
        for n in ("keys", "w2f"):
            a[n] = torch.as_tensor(a[n]).to(torch.bfloat16).float().numpy()
    return a


def _layout(case, b, c, ts, seed):
    """Validity and classes: random, with an empty link 0; "cut runs": link
    2 full and of one class (a run longer than a tile); "count n": class 0
    holds exactly n valid slots, the first n in (link, column) order. Dead
    slots carry non-zero tags."""
    rng = np.random.default_rng(seed)
    valid = rng.random((b, c)) < 0.6
    valid[0] = False
    ecls = rng.integers(0, K, (b, c))
    if case == "all dead":
        valid[:] = False
    elif case == "cut runs":
        valid[2] = True
        ecls[2] = 1
    else:
        n = ts + (case == "count TS+1")
        ecls = rng.integers(1, K, (b, c))
        ecls.flat[np.flatnonzero(valid)[:n]] = 0
    return valid, np.where(valid, ecls, rng.integers(1, K, (b, c)))


def _bwd_args(a, bf16=False, dev="cpu"):
    """The backward's inputs: the plain forward's m, l and delta for a
    random cotangent."""
    t = {n: v.to(dev) for n, v in _torch_args(a, bf16=bf16).items()}
    out, m, l = tpam.fused_pe_link_attention_mixed_plain(**t)
    g_out = torch.as_tensor(_cot(a, 3)).to(dev)
    delta = (g_out * (out - t["bias"])).sum(-1)
    return [t[n] for n in ORDER] + [m, l, g_out, delta]


def tagged_mirror(args, **kw):
    """``mirror_bwd`` over ``compact_tagged_slots``' list, from the mixed
    plain backward's arguments ``args`` (ORDER, then m, l, g_out,
    delta)."""
    slots, offsets = tpam.compact_tagged_slots(args[3], args[4], K)
    return mirror_bwd(*args[:3], *args[5:], slots, offsets, **kw)


# (validity layout, O, dh); the mirror's tiles hold TS = 8 slots
MIRROR_CASES = {
    "tiles cut runs": ("cut runs", 16, 16),
    "class count TS": ("count TS", 16, 16),
    "class count TS+1": ("count TS+1", 16, 16),
    "widths 70/36": ("cut runs", 70, 36),
}


# ... and the forward's: (u, u) links, whose ps and pt are equal (src =
# tgt), and a batch with no valid slot
FWD_MIRROR_CASES = dict(MIRROR_CASES, **{
    "(u, u) links": ("cut runs", 16, 16),
    "all dead": ("all dead", 16, 16),
})


def tagged_mirror_fwd(t, **kw):
    """``mirror_fwd`` over ``compact_tagged_slots``' list, from the mixed
    plain forward's inputs ``t`` (by name)."""
    slots, offsets = tpam.compact_tagged_slots(t["valid"], t["ecls"], K)
    return mirror_fwd(*[t[n] for n in FWD_ORDER], slots, offsets, **kw)


@pytest.mark.parametrize("case", list(FWD_MIRROR_CASES))
def test_mirror_fwd_matches_mixed_plain_f32(case):
    layout, o, dh = FWD_MIRROR_CASES[case]
    valid, ecls = _layout(layout, 8, 16, 8, seed=len(case))
    a = _draw(valid, ecls, len(case), o=o, dh=dh)
    if case == "(u, u) links":         # links 2 and 3: ppr(u, v) twice
        a["pt"][2:4] = a["ps"][2:4]
    t = _torch_args(a)
    stats = {}
    got = tagged_mirror_fwd(t, stats=stats)
    want = tpam.fused_pe_link_attention_mixed_plain(**t)
    if layout == "cut runs":
        assert stats["cut_runs"] > 0
    elif layout == "all dead":
        assert stats["tiles"] == 0
    else:
        _, offsets = tpam.compact_tagged_slots(t["valid"], t["ecls"], K)
        assert int(offsets[1]) == 8 + (layout == "count TS+1")
    assert not bool(t["valid"][0].any())         # link 0 is empty
    assert_fwd_close(got, want, t["valid"], t["bias"])


@pytest.mark.parametrize("mode", ["mixed", "single"])
def test_mirror_fwd_matches_mixed_pallas_f32(mode):
    """The forward's tile algorithm over the combined compaction against
    the JAX package's mixed Pallas forward (interpret mode): out, m and l.
    Tiles of 4 cut the full link's runs."""
    a = _inputs(K, seed=14, mode=mode)
    t = _torch_args(a)
    stats = {}
    got = tagged_mirror_fwd(t, ts=4, stats=stats)
    assert stats["cut_runs"] > 0
    assert_fwd_close(got, _jax(a), t["valid"], t["bias"])


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_mirror_matches_mixed_plain_f32(case):
    layout, o, dh = MIRROR_CASES[case]
    valid, ecls = _layout(layout, 8, 16, 8, seed=len(case))
    args = _bwd_args(_draw(valid, ecls, len(case), o=o, dh=dh))
    stats = {}
    got = tagged_mirror(args, stats=stats)
    want = tpam.fused_pe_link_attention_mixed_bwd_plain(*args)
    if layout == "cut runs":
        assert stats["cut_runs"] > 0
    else:
        _, offsets = tpam.compact_tagged_slots(args[3], args[4], K)
        assert int(offsets[1]) == 8 + (layout == "count TS+1")
    for n, x, y in zip(NAMES, got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert_close_scaled(x.numpy(), y.numpy(), 1e-4, 1e-5, n)
    assert bool((got[0][~args[3]] == 0).all())
    assert bool((got[1][0] == 0).all())          # the empty link's dq


@pytest.mark.parametrize("mode", ["mixed", "single"])
def test_mirror_matches_mixed_pallas_vjp_f32(mode):
    """The tile algorithm over the combined compaction against the JAX
    package's mixed Pallas backward (interpret mode): its grads of keys, q
    and every weight. Tiles of 4 cut the full link's runs."""
    a = _inputs(K, seed=13, mode=mode)
    g_out = _cot(a, 13)
    _, jg = _jax_grads(a, g_out)
    out, m, l = _jax(a)
    t = _torch_args(a)
    go = torch.as_tensor(g_out)
    delta = (go * (torch.as_tensor(np.array(out)) - t["bias"])).sum(-1)
    args = [t[n] for n in ORDER] + [torch.as_tensor(np.array(m)),
                                    torch.as_tensor(np.array(l)), go, delta]
    stats = {}
    dkeys, dq, dw1cat, dg, db, dw2, dcb, datt = tagged_mirror(
        args, ts=4, step=4, stats=stats)
    assert stats["cut_runs"] > 0
    w1, b1 = tpam.split_layer1_grads(dw1cat)
    got = dict(keys=dkeys, q=dq, w1=w1, b1=b1, g=dg, b=db, w2f=dw2,
               cbias=dcb, att=datt)
    for n in DIFF[:-1]:
        assert_close_scaled(got[n].numpy(), jg[n], 1e-4, 1e-5, n)


def test_four_classes_refused():
    """The tile kernels take K <= 3 classes (the combined table has three):
    the CUDA wrapper's checks refuse K = 4 before a launch (they do not
    depend on the device, so CPU tensors exercise them)."""
    a = _torch_args(_inputs(4, seed=0, mode="mixed"))
    with pytest.raises(ValueError, match="K <= 3"):
        tpam._check(*a.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["count TS", "count TS+1"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("o,dh", [(16, 16), (256, 256)])
def test_kernels_match_plain_on_card(o, dh, bf16, case):
    """The combined backward's kernels against the plain backward, class 0
    holding exactly a tile's slots or one more, dead slots tagged with
    other classes and link 0 empty: dead slots' dkeys rows and link 0's dq
    exactly zero. It runs under ``set_sync_debug_mode("error")``: a host
    synchronisation in the compaction or the wrapper fails the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ts = tpam.tile_slots(o, dh)
    valid, ecls = _layout(case, 24, 16, ts, seed=7)
    args = _bwd_args(_draw(valid, ecls, 7, o=o, dh=dh, bf16=bf16), bf16=bf16,
                     dev="cuda")
    tpam._load_bwd()     # the build synchronises; the backward must not
    before = tpam.fused_pe_link_attention_mixed_bwd.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpam.fused_pe_link_attention_mixed_bwd(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tpam.fused_pe_link_attention_mixed_bwd.launches == before + 1
    _, offsets = tpam.compact_tagged_slots(args[3], args[4], K)
    assert int(offsets[1]) == ts + (case == "count TS+1")
    want = tpam.fused_pe_link_attention_mixed_bwd_plain(*args)
    tol = 2e-2 if bf16 else 1e-4
    for n, x, y in zip(NAMES, got, want):
        assert x.dtype == y.dtype, n
        assert_close_card(x, y, tol, n)
    assert bool((got[0][~args[3]] == 0).all())
    assert bool((got[1][0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["combined", "classic"])
def test_backward_never_syncs_at_the_main_shape(table):
    """Both tables' backward wrappers under ``set_sync_debug_mode("error")``
    at the main path's B and C (B*C of 524,288 and 1,310,720, where
    ``torch.sort`` runs CUB's radix sort, not the small in-place sort it
    takes up to 4,096 slots), at O = dh = 16 to stay small; the outputs
    held to the plain backward at the bf16 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lpformer_tpu_torch.utils import measure

    if table == "combined":
        mod, bwd, plain = (tpam, tpam.fused_pe_link_attention_mixed_bwd,
                           tpam.fused_pe_link_attention_mixed_bwd_plain)
        a = measure.kernel_inputs("cuda", torch.bfloat16, o=16, dh=16)
    else:
        mod, bwd, plain = (tpa, tpa.fused_pe_link_attention_bwd,
                           tpa.fused_pe_link_attention_bwd_plain)
        a = measure.classic_kernel_inputs("cuda", torch.bfloat16, o=16,
                                          dh=16)
    a = measure.bwd_inputs(a)
    assert a["valid"].numel() > 4096
    mod._load_bwd()      # the build synchronises; the backward must not
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bwd(**a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = plain(**a)
    for n, x, y in zip(NAMES, got, want):
        assert x.dtype == y.dtype, n
        assert_close_card(x, y, 2e-2, n)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["combined", "classic"])
def test_forward_never_syncs_at_the_main_shape(table):
    """Both tables' forward wrappers under ``set_sync_debug_mode("error")``
    at the main path's B and C, as the backward's test above, at O = dh =
    16; the outputs held to the plain forward at chip_smoke.py's bf16
    tolerance: max |err| 1e-2 on out and m and relative on l, mean |err|
    1e-4 on out (a flipped bf16 rounding of h moves an output by up to
    ~5e-3; a logic error is O(0.1))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lpformer_tpu_torch.utils import measure

    if table == "combined":
        mod, fwd, plain = (tpam, tpam.fused_pe_link_attention_mixed,
                           tpam.fused_pe_link_attention_mixed_plain)
        a = measure.kernel_inputs("cuda", torch.bfloat16, o=16, dh=16)
    else:
        mod, fwd, plain = (tpa, tpa.fused_pe_link_attention,
                           tpa.fused_pe_link_attention_plain)
        a = measure.classic_kernel_inputs("cuda", torch.bfloat16, o=16,
                                          dh=16)
    assert a["valid"].numel() > 4096
    mod._load()          # the build synchronises; the forward must not
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, m, l = fwd(**a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = plain(**a)
    assert float((out - want[0]).abs().max()) <= 1e-2
    assert float((out - want[0]).abs().mean()) <= 1e-4
    assert float((m - want[1]).abs().max()) <= 1e-2
    assert float(((l - want[2]).abs() / want[2].abs().clamp_min(1.0)).max()
                 ) <= 1e-2


@pytest.mark.cuda
def test_four_classes_refused_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _bwd_args(_inputs(4, seed=0, mode="mixed"), dev="cuda")
    with pytest.raises(ValueError, match="K <= 3"):
        tpam.fused_pe_link_attention_mixed_bwd(*args)
