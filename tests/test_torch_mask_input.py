"""``mask_input`` in the port against lpformer_tpu: the masked propagation
weights, the BucketedELL's slot edge ids, the re-weighted BucketedELL
SpMM (forward and VJP), the bundle's train-edge ranks and its big-graph
BlockedCOO with edge ids, one training loss with double propagation
(every gradient leaf), and train_loop with ``mask_input`` end to end.

Parity runs with every dropout off and the negatives injected. The JAX
side runs its Pallas kernel pair of the classic table in interpret mode.
Tolerances, float32 (tests/test_torch_train.py, tests/test_torch_blocked.py):
SpMM rtol 1e-5 / atol 1e-6; the loss rtol 1e-5; gradients rtol 5e-4 /
atol 5e-5. Integer arrays and the masked weights are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data import dataset as jdataset
from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.graph import containers as jcont
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.ops import masking as jmask
from lpformer_tpu.ops import spmm as jspmm
from lpformer_tpu.train import step as jstep
from lpformer_tpu_torch.data import dataset as tdataset
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.graph import containers as tcont
from lpformer_tpu_torch.graph import ppr as tppr
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops import spmm as tspmm
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.train import trainer as ttrainer
from lpformer_tpu_torch.utils.params import from_jax_params

KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3, mask_input=True)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
# the pubmed-like preset's shape, cut to size: 1 GCN layer, the classic
# table
COMMON = dict(dim=16, gnn_layers=1, thresh_cn=0.0, thresh_1hop=1e-3,
              thresh_non1hop=1e-3, budget_cn=8, budget_onehop=16,
              budget_non1hop=16, **NO_DROP)
SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
B = 48


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


@pytest.mark.parametrize("u", [0, 1, 300])
def test_mask_edge_weights_matches_jax(u):
    rng = np.random.default_rng(u)
    bitmap = rng.random(u) < 0.4
    ranks = rng.integers(-1, max(u, 1), 500).astype(np.int32)
    ranks[:7] = -1
    w = rng.random(500).astype(np.float32)
    want = jmask.mask_edge_weights(jnp.asarray(bitmap), jnp.asarray(ranks),
                                   jnp.asarray(w))
    got = tmask.mask_edge_weights(torch.as_tensor(bitmap),
                                  torch.as_tensor(ranks), torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ranks of -1 are never masked
    np.testing.assert_array_equal(got.numpy()[:7], w[:7])


def _sorted_coo(seed=0, n=90, m=600):
    rng = np.random.default_rng(seed)
    from lpformer_tpu.graph import preprocess as jpp

    s, d, w = jpp.symmetrize(rng.integers(0, n, m), rng.integers(0, n, m),
                             None, n)
    return jpp.sort_by_dst(s.astype(np.int32), d.astype(np.int32), w, n), n


@pytest.mark.parametrize("with_edge_ids", [True, False])
def test_bell_slot_edges_match_jax(with_edge_ids):
    (s, d, w), n = _sorted_coo()
    j = jcont.BucketedELL.from_sorted_coo(s, d, n, w_norm=w,
                                          with_edge_ids=with_edge_ids)
    t = tcont.BucketedELL.from_sorted_coo(s, d, n, w_norm=w,
                                          with_edge_ids=with_edge_ids)
    if not with_edge_ids:
        assert j.slot_edges is None and t.slot_edges is None
        return
    assert len(t.slot_edges) == len(j.slot_edges) == len(j.caps)
    for a, b in zip(t.slot_edges, j.slot_edges):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))
    # BlockedBELL tiles keep only the static weights
    bb = tcont.BlockedBELL.from_coo(s, d, n, w, block=32)
    assert all(x is None or x.slot_edges is None for x in bb.tiles)


@pytest.mark.parametrize("bf16", [False, True])
def test_reweighted_spmm_bell_matches_jax(bf16):
    """``spmm_bell(bell, w_norm, ...)`` with batch-masked weights (a third
    of the edges at 0), forward and VJP, against JAX's."""
    (s, d, w), n = _sorted_coo(1)
    rng = np.random.default_rng(1)
    wm = np.where(rng.random(len(w)) < 0.33, 0.0, w).astype(np.float32)
    w_norm, diag = jspmm.gcn_norm_device(jnp.asarray(s), jnp.asarray(d),
                                         jnp.asarray(wm), n)
    w_norm, diag = np.asarray(w_norm), np.asarray(diag)
    # static slot weights of the unmasked graph, which w_norm must override
    jb = jcont.BucketedELL.from_sorted_coo(s, d, n, w_norm=w)
    tb = tcont.BucketedELL.from_sorted_coo(s, d, n, w_norm=w).to("cpu")
    x = rng.standard_normal((n, 24)).astype(np.float32)
    ct = rng.standard_normal((n, 24)).astype(np.float32)
    gd = jnp.bfloat16 if bf16 else None
    want, vjp = jax.vjp(lambda v: jspmm.spmm_bell(
        jb, jnp.asarray(w_norm), v, diag=jnp.asarray(diag), gather_dtype=gd),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w_norm).requires_grad_(True)
    out = tspmm.spmm_bell(tb, tw, tx, diag=torch.as_tensor(diag),
                          gather_dtype=torch.bfloat16 if bf16 else None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **SPMM_TOL)
    out.backward(torch.as_tensor(ct))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               **SPMM_TOL)
    assert tw.grad is None   # the weights take no gradient
    # a layout without slot edge ids cannot re-weight
    static = tcont.BucketedELL.from_sorted_coo(s, d, n, w_norm=w,
                                               with_edge_ids=False).to("cpu")
    with pytest.raises(ValueError):
        tspmm.spmm_bell(static, tw, tx)


def test_bundle_edge_rank_and_blocked_coo_match_jax(both):
    jd, td = both
    np.testing.assert_array_equal(td.graph.edge_rank.numpy(),
                                  np.asarray(jd.graph.edge_rank))
    assert td.graph.edge_rank.dtype == torch.int32
    assert (td.graph.edge_rank >= 0).all()   # every edge is a train edge
    assert td.graph.ell.slot_edges is not None and td.graph.blk is None
    # the big-graph layout, forced on the small graph: BlockedCOO with
    # edge ids, no BlockedBELL, no ELL
    n = td.num_nodes
    src, dst = jd.train_pos[:, 0], jd.train_pos[:, 1]
    ppr = tppr.ppr_push_csr(np.concatenate([src, dst]),
                            np.concatenate([dst, src]), n, 0.15, 1e-3)
    fields = (ppr.indptr, ppr.indices, ppr.weights, n)
    kw = dict(mask_uniq_keys=jd.mask_uniq_keys, build_blocked=True,
              mask_input=True)
    x = td.graph.x.numpy()
    jg = jdataset.build_graph_bundle(x, src, dst, None, n,
                                     jcont.CSRGraph(*fields), **kw)
    tg = tdataset.build_graph_bundle(x, src, dst, None, n,
                                     tcont.CSRGraph(*fields), **kw,
                                     device="cpu")
    assert tg.ell is None and tg.bbell is None and jg.ell is None
    assert tg.blk.kb == jg.blk.kb == 1
    for f in ("sl", "dl", "tw", "te"):
        for a, b in zip(getattr(tg.blk, f), getattr(jg.blk, f)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    np.testing.assert_array_equal(tg.edge_rank.numpy(),
                                  np.asarray(jg.edge_rank))


def _blk_bundles(jd, td):
    """Both bundles with a BlockedCOO of block 32 (kb = 3) with edge ids
    in place of the ELL: the big-graph mask_input layout on the tiny
    graph."""
    g = td.graph
    s, d, w = g.edge_src.numpy(), g.edge_dst.numpy(), g.w_norm.numpy()
    jb = jcont.BlockedCOO.from_coo(s, d, g.num_nodes, w_norm=w, block=32,
                                   pad_to=64)
    tb = tcont.BlockedCOO.from_coo(s, d, g.num_nodes, w_norm=w, block=32,
                                   pad_to=64).to("cpu")
    return (dataclasses.replace(jd.graph, ell=None, blk=jb),
            dataclasses.replace(g, ell=None, blk=tb))


@pytest.mark.parametrize("layout", ["ell", "blk"])
def test_double_propagation_loss_and_grads_match_jax(both, layout):
    """One step's loss with the batch's train edges masked out of the
    positive half's propagation (its norm recomputed on the device) and a
    second, static-norm propagation for the negative half: the loss and
    every gradient leaf against JAX's loss_fn(prop_edge_w, double
    propagation), through the BucketedELL or the BlockedCOO."""
    jd, td = both
    jg, tg = ((jd.graph, td.graph) if layout == "ell"
              else _blk_bundles(jd, td))
    jcfg = JConfig(**COMMON, use_pallas_attention=True)
    jp = jlt.init_lpformer(jax.random.PRNGKey(3), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = toptim.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    rng = np.random.default_rng(10)
    pos = td.train_pos[rng.choice(len(td.train_pos), B, replace=False)]
    w = np.ones(B, np.float32)
    w[-5:] = 0.0
    neg = rng.integers(0, KW["num_nodes"], (2, B))

    src, tgt, jw, jneg = (jnp.asarray(a) for a in (pos[:, 0], pos[:, 1], w,
                                                    neg))
    mr = jmask.batch_mask_ranks(jg.adj_rows, src, tgt, jd.mask_mult_device,
                                weight=jw)
    jprop = jmask.mask_edge_weights(mr, jg.edge_rank,
                                    (jg.edge_w > 0).astype(jnp.float32))
    jl, jgr = jax.jit(jax.value_and_grad(
        lambda p, g, *a: jstep.loss_fn(p, jcfg, g, *a,
                                       jax.random.PRNGKey(0), True)))(
        jp, jg, src, tgt, jneg[0], jneg[1], jw, mr, jprop)

    src, tgt, tw, tneg = (torch.as_tensor(a) for a in (pos[:, 0], pos[:, 1],
                                                        w, neg))
    mr = tmask.batch_mask_ranks(tg.adj_rows, src, tgt, td.mask_mult_device,
                                weight=tw)
    tprop = tmask.mask_edge_weights(mr, tg.edge_rank,
                                    (tg.edge_w > 0).float())
    np.testing.assert_array_equal(tprop.numpy(), np.asarray(jprop))
    assert (tprop == 0).any()   # the batch masks propagation edges
    loss = tstep.loss_fn(tp, TConfig(**COMMON), tg, src, tgt, tneg[0],
                         tneg[1], tw, mr, None, tprop, True)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
               for p, x in jax.tree_util.tree_leaves_with_path(jgr)]
    assert len(jleaves) == len(grads)
    for (path, want), g, x in zip(jleaves, grads, leaves):
        got = torch.zeros_like(x) if g is None else g
        np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                   **GRAD_TOL)
    # prop_edge_w needs the second propagation
    with pytest.raises(ValueError):
        tstep.loss_fn(tp, TConfig(**COMMON), tg, src, tgt, tneg[0], tneg[1],
                      tw, mr, None, tprop, False)


def test_train_loop_with_mask_input(both):
    """Two epochs with mask_input and the preset's dropouts: every loss
    finite, one logged result per epoch, metrics in [0, 1]."""
    _, td = both
    cfg = TConfig(**dict(COMMON, dropout=0.3, gnn_drop=0.3, att_drop=0.3,
                         feat_drop=0.3, pred_drop=0.3))
    args = ttrainer.TrainArgs(epochs=2, batch_size=64, test_batch_size=64,
                              eval_steps=1, mask_input=True, l2=1e-4,
                              verbose=False)
    loggers = {k: ttrainer.ResultsLogger(1) for k in
               ("Hits@20", "Hits@50", "Hits@100", "MRR")}
    losses = []
    ttrainer.train_loop(args, cfg, td, loggers, 0, step_losses=losses)
    assert len(losses) == 2 * -(-len(td.train_pos) // 64)
    assert all(bool(torch.isfinite(x)) for x in losses)
    for lg in loggers.values():
        assert len(lg.results[0]) == 2
        assert all(0.0 <= v <= 1.0 for r in lg.results[0] for v in r)
