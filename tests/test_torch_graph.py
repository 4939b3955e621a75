"""The port's host graph build against lpformer_tpu's, array for array.

The same seed goes through both packages' synthetic_dataset; the splits,
features and every array of the graph bundle must be equal (exactly: both
sides run the same numpy code and the same native PPR push source)."""
import numpy as np
import pytest

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.graph import ppr as jax_ppr
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.graph import ppr

KW = dict(seed=3, num_nodes=120, num_train=400, num_eval=40, feat_dim=12,
          eps=1e-3)


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


def _eq(a, b, name):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_splits_and_features_identical(both):
    jd, td = both
    for name in ("train_pos", "train_pos_val", "valid_pos", "valid_neg",
                 "test_pos", "test_neg", "mask_uniq_keys", "mask_mult"):
        np.testing.assert_array_equal(getattr(jd, name), getattr(td, name),
                                      err_msg=name)
    _eq(jd.graph.x, td.graph.x, "x")


@pytest.mark.parametrize("cap", [None, 4])
def test_graph_bundle_identical(cap):
    kw = dict(KW, adj_cap=cap, ppr_cap=cap)
    jg = jax_synthetic(**kw).graph
    tg = synthetic_dataset(**kw, device="cpu").graph
    for name in ("edge_src", "edge_dst", "edge_w", "degree", "w_norm",
                 "w_diag"):
        _eq(getattr(jg, name), getattr(tg, name), name)
    for rows in ("adj_rows", "ppr_rows"):
        jr, tr = getattr(jg, rows), getattr(tg, rows)
        assert (jr.cap, jr.num_nodes) == (tr.cap, tr.num_nodes)
        for f in ("nbrs", "vals", "counts"):
            _eq(getattr(jr, f), getattr(tr, f), f"{rows}.{f}")
    _eq(jg.ppr_rows.flags, tg.ppr_rows.flags, "ppr_rows.flags")
    assert jg.ell.caps == tg.ell.caps
    _eq(jg.ell.outmap, tg.ell.outmap, "ell.outmap")
    for i in range(len(jg.ell.caps)):
        _eq(jg.ell.nbs[i], tg.ell.nbs[i], f"ell.nbs[{i}]")
        _eq(jg.ell.w_slots[i], tg.ell.w_slots[i], f"ell.w_slots[{i}]")


def test_numpy_ppr_push_identical(monkeypatch):
    rng = np.random.default_rng(0)
    e = rng.integers(0, 40, size=(150, 2))
    e = e[e[:, 0] != e[:, 1]]
    s = np.concatenate([e[:, 0], e[:, 1]])
    d = np.concatenate([e[:, 1], e[:, 0]])
    # the JAX package's numpy push, reached with its native library off
    monkeypatch.setattr(jax_ppr, "_load_native", lambda: None)
    j = jax_ppr.ppr_push_csr(s, d, 40, 0.15, 1e-3)
    t = ppr.ppr_push_csr(s, d, 40, 0.15, 1e-3, method="numpy")
    np.testing.assert_array_equal(j.indptr, t.indptr)
    np.testing.assert_array_equal(j.indices, t.indices)
    np.testing.assert_array_equal(j.weights, t.weights)
    # and the native push agrees with the numpy one on the support
    n = ppr.ppr_push_csr(s, d, 40, 0.15, 1e-3, method="native")
    np.testing.assert_array_equal(n.indptr, t.indptr)
    np.testing.assert_array_equal(n.indices, t.indices)
    np.testing.assert_allclose(n.weights, t.weights, rtol=1e-6)


def test_bundle_refuses_blocked_sizes():
    from lpformer_tpu_torch.data.dataset import build_graph_bundle
    from lpformer_tpu_torch.graph.containers import CSRGraph

    n = 262_144
    # each node's PPR row holds itself alone
    empty = CSRGraph(np.arange(n + 1, dtype=np.int64),
                     np.arange(n, dtype=np.int32), np.ones(n, np.float32), n)
    # at this size the bundle takes the tiled BlockedBELL (the JAX
    # package's rule); the batch-masked variant (mask_input) the
    # BlockedCOO with edge ids, which re-weights
    g = build_graph_bundle(np.zeros((n, 1), np.float32), np.array([0]),
                           np.array([1]), None, n, empty, device="cpu")
    assert g.ell is None and g.bbell.kb == 2
    g = build_graph_bundle(np.zeros((n, 1), np.float32), np.array([0]),
                           np.array([1]), None, n, empty, mask_input=True,
                           device="cpu")
    assert g.ell is None and g.bbell is None and g.blk.kb == 2
    assert g.blk.te is not None and g.blk.tw is not None
