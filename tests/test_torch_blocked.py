"""The port's big-graph propagation against lpformer_tpu's: the tiled
layouts (BlockedBELL, BlockedCOO) and the hybrid ELLAdjacency array for
array, every SpMM forward and VJP, the GCN normalisations, and propagate,
scores and one training step on a bundle that carries the small-block
tiles; then the layout selection of build_graph_bundle.

The graphs are small (300 nodes), so the tiles are built with a block of
64 (kb = 5, a ragged last block, and empty tiles where no edge joins two
blocks), as the JAX package's own tests do (tests/test_kernels.py:398-450),
and reach the bundle through ``dataclasses.replace``.

Tolerances, float32: the SpMMs rtol 1e-5 / atol 1e-6, the JAX package's
own for its tiled SpMM against the COO one; with bf16 gather both sides
round the same x once, so the same bound holds. Propagate and scores rtol
5e-4 / atol 5e-5 (tests/test_torch_model.py), the step's loss rtol 1e-5
and grads rtol 5e-4 / atol 5e-5 (tests/test_torch_train.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.graph import containers as jcont
from lpformer_tpu.graph import preprocess as jpp
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.ops import masking as jmask
from lpformer_tpu.ops import spmm as jspmm
from lpformer_tpu.train import step as jstep
from lpformer_tpu_torch.data.dataset import BLOCKED_MIN_NODES
from lpformer_tpu_torch.data.dataset import build_graph_bundle
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.graph import containers as tcont
from lpformer_tpu_torch.graph import preprocess as tpp
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops import spmm as tspmm
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.utils.params import from_jax_params

SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
N, BLOCK = 300, 64


def _graph(seed=0, n=N, m=1500, block=BLOCK):
    """A symmetrised, dst-sorted random graph with no edge between the
    first and the last block (two empty tiles), its GCN norm, and the
    numpy inputs of both packages' layouts."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    far = {(0, (n - 1) // block), ((n - 1) // block, 0)}
    keep = [(s // block, d // block) not in far for s, d in zip(src, dst)]
    s, d, w = jpp.symmetrize(src[keep], dst[keep], None, n)
    s, d, w = jpp.sort_by_dst(s.astype(np.int32), d.astype(np.int32), w, n)
    w_norm, diag = jspmm.gcn_norm_device(jnp.asarray(s), jnp.asarray(d),
                                         jnp.asarray(w), n)
    return s, d, w, np.asarray(w_norm), np.asarray(diag)


def _eq(a, b, name):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def _bell_eq(j, t, name):
    assert j.caps == t.caps and j.num_nodes == t.num_nodes, name
    assert j.num_edges == t.num_edges and j.slot_total == t.slot_total, name
    _eq(j.outmap, t.outmap, f"{name}.outmap")
    for i in range(len(j.caps)):
        _eq(j.nbs[i], t.nbs[i], f"{name}.nbs[{i}]")
        _eq(j.w_slots[i], t.w_slots[i], f"{name}.w_slots[{i}]")


def test_blocked_bell_tiles_equal_jax():
    s, d, _, w_norm, _ = _graph()
    jb = jcont.BlockedBELL.from_coo(s, d, N, w_norm, block=BLOCK)
    tb = tcont.BlockedBELL.from_coo(s, d, N, w_norm, block=BLOCK)
    assert (tb.kb, tb.block, tb.num_nodes, tb.num_edges) == (
        jb.kb, jb.block, jb.num_nodes, jb.num_edges) == (5, BLOCK, N, len(s))
    assert tb.slot_total == jb.slot_total
    empty = [t is None for t in tb.tiles]
    assert empty == [t is None for t in jb.tiles]
    assert empty[4] and empty[20] and sum(empty) == 2
    for k, (j, t) in enumerate(zip(jb.tiles, tb.tiles)):
        if t is not None:
            _bell_eq(j, t, f"tile {k}")
    # one block: no tiling
    assert tcont.BlockedBELL.from_coo(s, d, N, w_norm, block=N) is None


@pytest.mark.parametrize("weights", [True, False])
def test_blocked_coo_tiles_equal_jax(weights):
    s, d, _, w_norm, _ = _graph()
    w = w_norm if weights else None
    jb = jcont.BlockedCOO.from_coo(s, d, N, w_norm=w, block=BLOCK)
    tb = tcont.BlockedCOO.from_coo(s, d, N, w_norm=w, block=BLOCK)
    assert (tb.kb, tb.slot_total) == (jb.kb, jb.slot_total)
    assert (tb.tw is None) == (not weights)
    for f in ("sl", "dl", "te") + (("tw",) if weights else ()):
        jt, tt = getattr(jb, f), getattr(tb, f)
        assert len(jt) == len(tt) == 25
        for k in range(25):
            _eq(jt[k], tt[k], f"{f}[{k}]")
    no_ids = tcont.BlockedCOO.from_coo(s, d, N, w_norm=w, block=BLOCK,
                                       with_edge_ids=False)
    assert no_ids.te is None


def test_ell_adjacency_equals_jax():
    s, d, _, w_norm, _ = _graph()
    je = jcont.ELLAdjacency.from_sorted_coo(s, d, N).with_weights(w_norm)
    te = tcont.ELLAdjacency.from_sorted_coo(s, d, N).with_weights(w_norm)
    assert te.cap == je.cap > 0 and len(te.ov_src) > 0
    for f in ("nb", "slot_edge", "ov_src", "ov_dst", "ov_edge", "w_slots",
              "ov_w"):
        _eq(getattr(je, f), getattr(te, f), f)


def test_gcn_norms_match_jax():
    s, d, w, w_norm, diag = _graph()
    tw, tdiag = tspmm.gcn_norm_device(torch.as_tensor(s), torch.as_tensor(d),
                                      torch.as_tensor(w), N)
    np.testing.assert_allclose(tw.numpy(), w_norm, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tdiag.numpy(), diag, rtol=1e-6, atol=0)
    for loops in (True, False):
        want = jpp.gcn_norm_edges(s, d, w, N, add_self_loops=loops)
        got = tpp.gcn_norm_edges(s, d, w, N, add_self_loops=loops)
        for a, b in zip(want, got):
            _eq(a, b, f"gcn_norm_edges loops={loops}")


def _layouts():
    s, d, w, w_norm, diag = _graph()
    jw, tw_ = jnp.asarray(w_norm), torch.tensor(w_norm)
    jd, td = jnp.asarray(diag), torch.tensor(diag)
    js, jdd, jew = jnp.asarray(s), jnp.asarray(d), jnp.asarray(w)
    ts, tdd = torch.as_tensor(s), torch.as_tensor(d)
    jb = jcont.BlockedBELL.from_coo(s, d, N, w_norm, block=BLOCK)
    tb = tcont.BlockedBELL.from_coo(s, d, N, w_norm, block=BLOCK).to("cpu")
    jk = jcont.BlockedCOO.from_coo(s, d, N, w_norm=w_norm, block=BLOCK)
    tk = tcont.BlockedCOO.from_coo(s, d, N, w_norm=w_norm,
                                   block=BLOCK).to("cpu")
    je = jcont.ELLAdjacency.from_sorted_coo(s, d, N).with_weights(w_norm)
    te = tcont.ELLAdjacency.from_sorted_coo(s, d, N).with_weights(
        w_norm).to("cpu")
    # (JAX op, port op) on x, with gather dtype gd (None or bf16)
    return {
        "bbell": (lambda x, g: jspmm.spmm_bbell(jb, x, diag=jd,
                                                gather_dtype=g),
                  lambda x, g: tspmm.spmm_bbell(tb, x, diag=td,
                                                gather_dtype=g)),
        "blocked_static": (
            lambda x, g: jspmm.spmm_blocked(jk, None, x, diag=jd,
                                            gather_dtype=g),
            lambda x, g: tspmm.spmm_blocked(tk, None, x, diag=td,
                                            gather_dtype=g)),
        "blocked_dynamic": (
            lambda x, g: jspmm.spmm_blocked(jk, jw, x, diag=jd,
                                            gather_dtype=g),
            lambda x, g: tspmm.spmm_blocked(tk, tw_, x, diag=td,
                                            gather_dtype=g)),
        "coo": (lambda x, g: jspmm.spmm(js, jdd, jw, x, N, diag=jd,
                                        gather_dtype=g),
                lambda x, g: tspmm.spmm(ts, tdd, tw_, x, N, diag=td,
                                        gather_dtype=g)),
        "ell_static": (lambda x, g: jspmm.spmm_ell(je, None, x, diag=jd,
                                                   gather_dtype=g),
                       lambda x, g: tspmm.spmm_ell(te, None, x, diag=td,
                                                   gather_dtype=g)),
        "ell_dynamic": (lambda x, g: jspmm.spmm_ell(je, jw, x, diag=jd,
                                                    gather_dtype=g),
                        lambda x, g: tspmm.spmm_ell(te, tw_, x, diag=td,
                                                    gather_dtype=g)),
        "propagate": (
            lambda x, g: jspmm.gcn_propagate(js, jdd, jew, x, N),
            lambda x, g: tspmm.gcn_propagate(ts, tdd, torch.as_tensor(w), x,
                                             N)),
    }


@pytest.mark.parametrize("layout,bf16", [
    (layout, bf16) for layout in ("bbell", "blocked_static",
                                  "blocked_dynamic", "coo", "ell_static",
                                  "ell_dynamic")
    for bf16 in (False, True)] + [("propagate", False)])
def test_spmm_forward_and_vjp_match_jax(layout, bf16):
    jop, top = _layouts()[layout]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 24)).astype(np.float32)
    ct = rng.standard_normal((N, 24)).astype(np.float32)
    jg, tg = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)

    @jax.jit
    def jax_fwd_vjp(v, c):
        out, vjp = jax.vjp(lambda u: jop(u, jg), v)
        return out, vjp(c)[0]

    want, want_dx = jax_fwd_vjp(jnp.asarray(x), jnp.asarray(ct))
    tx = torch.as_tensor(x).requires_grad_(True)
    got = top(tx, tg)
    got.backward(torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **SPMM_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               **SPMM_TOL)


def test_coo_symmetric_vjp_is_autograds():
    """The COO SpMM's symmetric backward (A ct) equals autograd's transpose
    of the gather + index_add (symmetric=False), as the JAX package's
    tests/test_gather_vjp.py holds its own."""
    s, d, _, w_norm, diag = _graph()
    ts, td, tw = (torch.as_tensor(a) for a in (s, d, w_norm))
    tdiag = torch.tensor(diag)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((N, 8)), dtype=torch.float32)
    ct = torch.tensor(rng.standard_normal((N, 8)), dtype=torch.float32)
    grads = []
    for sym in (True, False):
        v = x.clone().requires_grad_(True)
        (tspmm.spmm(ts, td, tw, v, N, diag=tdiag, symmetric=sym) * ct).sum(
            ).backward()
        grads.append(v.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], **SPMM_TOL)


def test_blocked_dynamic_needs_edge_ids():
    s, d, _, w_norm, _ = _graph()
    tk = tcont.BlockedCOO.from_coo(s, d, N, w_norm=w_norm, block=BLOCK,
                                   with_edge_ids=False).to("cpu")
    with pytest.raises(ValueError):
        tspmm.spmm_blocked(tk, torch.as_tensor(w_norm),
                           torch.zeros(N, 4))


KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
COMMON = dict(dim=16, gnn_layers=2, thresh_cn=0.0, thresh_1hop=1e-3,
              thresh_non1hop=1e-3, budget_combined=32, **NO_DROP)
TILE = 32   # 80 nodes: kb = 3, the last block 16 rows


def _tiled(graph, cont, layout):
    """The bundle with its BucketedELL replaced by small-block tiles."""
    s, d = np.asarray(graph.edge_src), np.asarray(graph.edge_dst)
    w = np.asarray(graph.w_norm)
    if layout == "bbell":
        return dataclasses.replace(graph, ell=None, bbell=(
            cont.BlockedBELL.from_coo(s, d, graph.num_nodes, w, block=TILE)))
    return dataclasses.replace(graph, ell=None, blk=cont.BlockedCOO.from_coo(
        s, d, graph.num_nodes, w_norm=w, block=TILE))


@pytest.fixture(scope="module")
def tiled():
    jd, td = jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")
    return {layout: (_tiled(jd.graph, jcont, layout),
                     _tiled(td.graph, tcont, layout).to("cpu"))
            for layout in ("bbell", "blk")}, jd


def _params():
    jcfg = JConfig(**COMMON, use_pallas_attention=False)
    jp = jlt.init_lpformer(jax.random.PRNGKey(3), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TConfig(**COMMON), tp


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(tspmm, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tspmm, name, counted)
    return calls


@pytest.mark.parametrize("layout", ["bbell", "blk"])
def test_propagate_and_scores_on_tiles_match_jax(tiled, layout, monkeypatch):
    graphs, jd = tiled
    jg, tg = graphs[layout]
    jcfg, jp, tcfg, tp = _params()
    calls = _count_calls(monkeypatch, "spmm_bbell" if layout == "bbell"
                         else "spmm_blocked")
    links = np.concatenate([jd.valid_pos[:12], jd.valid_neg[:4]])

    @jax.jit
    def jax_scores(p, g, s, t):
        x = jlt.propagate(p, jcfg, g)
        return x, jlt.score_links(p, jcfg, jlt.forward(
            p, jcfg, g, s, t, train=False, X_node=x))

    jx, jsc = jax_scores(jp, jg, jnp.asarray(links[:, 0]),
                         jnp.asarray(links[:, 1]))
    tx = tlt.propagate(tp, tcfg, tg)
    tsc = tlt.score_links(tp, tcfg, tlt.forward(
        tp, tcfg, tg, torch.as_tensor(links[:, 0]),
        torch.as_tensor(links[:, 1]), X_node=tx))
    assert len(calls) == COMMON["gnn_layers"]
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **MODEL_TOL)
    np.testing.assert_allclose(tsc.detach().numpy(), np.asarray(jsc),
                               **MODEL_TOL)


def test_training_step_on_bbell_matches_jax(tiled, monkeypatch):
    graphs, jd = tiled
    jg, tg = graphs["bbell"]
    jcfg, jp, tcfg, tp = _params()
    calls = _count_calls(monkeypatch, "spmm_bbell")
    rng = np.random.default_rng(10)
    pos = jd.train_pos[rng.choice(len(jd.train_pos), 48, replace=False)]
    w = np.ones(48, np.float32)
    w[-5:] = 0.0
    neg = rng.integers(0, KW["num_nodes"], (2, 48))
    src, tgt, jw, jneg = (jnp.asarray(a) for a in (pos[:, 0], pos[:, 1], w,
                                                    neg))
    mr = jmask.batch_mask_ranks(jg.adj_rows, src, tgt, jd.mask_mult_device,
                                weight=jw)
    jl, jgr = jax.jit(jax.value_and_grad(
        lambda p, g, *a: jstep.loss_fn(p, jcfg, g, *a, None,
                                       jax.random.PRNGKey(0), False)))(
        jp, jg, src, tgt, jneg[0], jneg[1], jw, mr)

    leaves = toptim.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    src, tgt, tw, tneg = (torch.as_tensor(a) for a in (pos[:, 0], pos[:, 1],
                                                        w, neg))
    mult = torch.as_tensor(jd.mask_mult, dtype=torch.int32)
    mr = tmask.batch_mask_ranks(tg.adj_rows, src, tgt, mult, weight=tw)
    loss = tstep.loss_fn(tp, tcfg, tg, src, tgt, tneg[0], tneg[1], tw, mr,
                         None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert calls
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
               for p, x in jax.tree_util.tree_leaves_with_path(jgr)]
    assert len(jleaves) == len(grads)
    for (path, want), g, x in zip(jleaves, grads, leaves):
        got = torch.zeros_like(x) if g is None else g
        np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                   **GRAD_TOL)


def _self_ppr(n):
    """PPR rows that hold each node itself alone."""
    return tcont.CSRGraph(indptr=np.arange(n + 1, dtype=np.int64),
                          indices=np.arange(n, dtype=np.int32),
                          weights=np.ones(n, np.float32), num_nodes=n)


def test_layout_selection_follows_jax():
    """From 262,144 nodes the bundle carries the BlockedBELL (kb = 2 at
    the default block of 131,072) and no ELL; below it the BucketedELL;
    build_ell / build_blocked override either way; mask_input takes the
    BlockedCOO with edge ids on big graphs and the BucketedELL with its
    slots' edge ids on small ones."""
    rng = np.random.default_rng(0)
    n = BLOCKED_MIN_NODES
    e = rng.integers(0, n, (20_000, 2))
    e = e[e[:, 0] != e[:, 1]]
    x = np.zeros((n, 1), np.float32)
    g = build_graph_bundle(x, e[:, 0], e[:, 1], None, n, _self_ppr(n),
                           adj_cap=8, ppr_cap=1, device="cpu")
    assert g.ell is None and g.blk is None and g.bbell.kb == 2
    assert g.bbell.block == 131_072 and g.bbell.num_edges == g.num_edges
    assert g.bbell.slot_total >= g.num_edges
    s, d = g.edge_src.numpy(), g.edge_dst.numpy()
    jb = jcont.BlockedBELL.from_coo(s, d, n, g.w_norm.numpy())
    assert jb.slot_total == g.bbell.slot_total

    small = e[(e < 1000).all(1)]
    g = build_graph_bundle(np.zeros((1000, 1), np.float32), small[:, 0],
                           small[:, 1], None, 1000, _self_ppr(1000),
                           device="cpu")
    assert g.ell is not None and g.bbell is None and g.blk is None
    # forcing the tiles on one block gives none (kb = 1): the ELL stays
    g = build_graph_bundle(np.zeros((1000, 1), np.float32), small[:, 0],
                           small[:, 1], None, 1000, _self_ppr(1000),
                           build_blocked=True, device="cpu")
    assert g.ell is not None and g.bbell is None
    g = build_graph_bundle(np.zeros((1000, 1), np.float32), small[:, 0],
                           small[:, 1], None, 1000, _self_ppr(1000),
                           build_ell=False, device="cpu")
    assert g.ell is None and g.bbell is None
    g = build_graph_bundle(np.zeros((1000, 1), np.float32), small[:, 0],
                           small[:, 1], None, 1000, _self_ppr(1000),
                           mask_input=True, device="cpu")
    assert g.bbell is None and g.blk is None
    assert g.ell.slot_edges is not None
    g = build_graph_bundle(x, e[:, 0], e[:, 1], None, n, _self_ppr(n),
                           adj_cap=8, ppr_cap=1, mask_input=True,
                           device="cpu")
    assert g.ell is None and g.bbell is None and g.blk.kb == 2
    assert g.blk.te is not None
