"""The port's dataset readers against lpformer_tpu's, array for array.

The fixtures of tests/test_data_readers.py (a Planetoid directory with a
``gnn_feature`` torch file, HeaRT ``.npy`` negatives, a collab npz with
years and weights, a citation2 npz) go through both packages' readers.
Splits, ``train_pos_val``, features and the integer arrays of ``graph``
and ``graph_test`` must be equal; PPR-derived values agree to rtol 1e-6.
Also: a PPR cache written by either package is read by the other.
"""
import numpy as np
import pytest

from lpformer_tpu.data import ogb as jogb
from lpformer_tpu.data import planetoid as jplanetoid
from lpformer_tpu.data import synthetic as jsyn
from lpformer_tpu.graph import ppr as jppr
from lpformer_tpu_torch.data import ogb as togb
from lpformer_tpu_torch.data import planetoid as tplanetoid
from lpformer_tpu_torch.graph import ppr as tppr
from test_data_readers import _write_planetoid

SPLITS = ("train_pos", "train_pos_val", "valid_pos", "valid_neg", "test_pos",
          "test_neg")
PPR_RTOL = 1e-6


def _eq(a, b, name):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def _same_bundle(jg, tg, label):
    _eq(jg.x, tg.x, f"{label}.x")
    for name in ("edge_src", "edge_dst", "edge_w", "degree", "w_norm"):
        _eq(getattr(jg, name), getattr(tg, name), f"{label}.{name}")
    assert jg.num_edges == tg.num_edges
    for rows in ("adj_rows", "ppr_rows"):
        jr, tr = getattr(jg, rows), getattr(tg, rows)
        assert (jr.cap, jr.num_nodes) == (tr.cap, tr.num_nodes), rows
        for f in ("nbrs", "counts"):
            _eq(getattr(jr, f), getattr(tr, f), f"{label}.{rows}.{f}")
        # self-PPR on the adjacency rows, PPR on the PPR rows
        np.testing.assert_allclose(tr.vals.numpy(), np.asarray(jr.vals),
                                   rtol=PPR_RTOL,
                                   err_msg=f"{label}.{rows}.vals")
    _eq(jg.ppr_rows.flags, tg.ppr_rows.flags, f"{label}.ppr_rows.flags")
    _eq(jg.adj_rows.ranks, tg.adj_rows.ranks, f"{label}.adj_rows.ranks")


def _same_dataset(jd, td):
    assert (jd.name, jd.num_nodes, jd.metric, jd.heart) == (
        td.name, td.num_nodes, td.metric, td.heart)
    for name in SPLITS:
        np.testing.assert_array_equal(getattr(jd, name), getattr(td, name),
                                      err_msg=name)
    _same_bundle(jd.graph, td.graph, "graph")
    assert (jd.graph_test is jd.graph) == (td.graph_test is td.graph)
    if td.graph_test is not td.graph:
        _same_bundle(jd.graph_test, td.graph_test, "graph_test")


@pytest.mark.parametrize("heart", [False, True], ids=["plain", "heart"])
def test_planetoid_reader_matches(tmp_path, heart):
    data_dir, name, n, _, va = _write_planetoid(tmp_path, seed=int(heart))
    kw = {}
    if heart:
        hd = tmp_path / "heart" / name
        hd.mkdir(parents=True)
        rng = np.random.default_rng(2)
        np.save(hd / "heart_valid_samples.npy",
                jsyn.random_edges(rng, n, len(va) * 5).reshape(len(va), 5, 2))
        np.save(hd / "heart_test_samples.npy",
                jsyn.random_edges(rng, n, 30 * 5).reshape(30, 5, 2))
        kw = dict(heart=True, heart_dir=str(tmp_path / "heart"))
    jd = jplanetoid.read_data_planetoid(
        name, data_dir=data_dir, eps=1e-3, cache_dir=str(tmp_path / "j"),
        **kw)
    td = tplanetoid.read_data_planetoid(
        name, data_dir=data_dir, eps=1e-3, cache_dir=str(tmp_path / "t"),
        device="cpu", **kw)
    assert td.num_nodes == n and td.graph.x.shape == (n, 12)
    if heart:
        assert td.valid_neg.shape == (len(va), 5, 2)
    _same_dataset(jd, td)


def _write_collab(tmp_path, n=80, seed=3):
    """tests/test_data_readers.py:test_ogb_npz_roundtrip's npz, with
    weighted, repeated train edges across years."""
    rng = np.random.default_rng(seed)
    tr = jsyn.random_edges(rng, n, 240)
    tr[-20:] = tr[:20]  # repeated collaborations in other years
    years = rng.integers(2000, 2015, len(tr))
    weights = rng.integers(1, 4, len(tr)).astype(np.float32)
    kept = tr[years >= 2007]
    src = np.concatenate([kept[:, 0], kept[:, 1]])
    dst = np.concatenate([kept[:, 1], kept[:, 0]])
    np.savez_compressed(
        tmp_path / "ogbl-collab.npz",
        num_nodes=n, train_pos=tr, train_year=years, train_weight=weights,
        valid_pos=jsyn.random_edges(rng, n, 30),
        valid_neg=jsyn.random_edges(rng, n, 30),
        test_pos=jsyn.random_edges(rng, n, 30),
        test_neg=jsyn.random_edges(rng, n, 30),
        edge_index=np.stack([src, dst]),
        edge_weight=np.ones(len(src), np.float32),
        x=rng.standard_normal((n, 8)).astype(np.float32),
    )
    return years


@pytest.mark.parametrize("use_val_in_test", [False, True])
def test_collab_npz_reader_matches(tmp_path, use_val_in_test):
    years = _write_collab(tmp_path)
    kw = dict(data_dir=str(tmp_path), eps=1e-3,
              use_val_in_test=use_val_in_test)
    jd = jogb.read_data_ogb("ogbl-collab", cache_dir=str(tmp_path / "j"),
                            **kw)
    td = togb.read_data_ogb("ogbl-collab", cache_dir=str(tmp_path / "t"),
                            device="cpu", **kw)
    assert td.metric == "Hits@50"
    assert len(td.train_pos) == (years >= 2007).sum()
    # the sum-reduced weights of repeated pairs reach the adjacency
    assert float(td.graph.edge_w.max()) > 3
    assert (td.graph_test is not td.graph) == use_val_in_test
    if use_val_in_test:
        assert td.graph_test.num_edges >= td.graph.num_edges
    _same_dataset(jd, td)


def test_filter_by_year_matches(tmp_path):
    _write_collab(tmp_path)
    raw = jogb._load_splits_npz(str(tmp_path / "ogbl-collab.npz"))
    traw = togb._load_splits_npz(str(tmp_path / "ogbl-collab.npz"))
    assert sorted(raw) == sorted(traw)
    j, t = jogb.filter_by_year(raw), togb.filter_by_year(traw)
    for k in ("train_pos", "train_weight", "edge_index", "edge_weight"):
        np.testing.assert_array_equal(j[k], t[k], err_msg=k)


def test_citation2_npz_reader_matches(tmp_path):
    rng = np.random.default_rng(7)
    n = 70
    tr = jsyn.random_edges(rng, n, 200)
    np.savez_compressed(
        tmp_path / "ogbl-citation2.npz",
        num_nodes=n, train_pos=tr,
        valid_pos=jsyn.random_edges(rng, n, 20),
        valid_neg=rng.integers(0, n, (20, 9)),
        test_pos=jsyn.random_edges(rng, n, 20),
        test_neg=rng.integers(0, n, (20, 9)),
        edge_index=np.stack([tr[:, 0], tr[:, 1]]),  # directed
        x=rng.standard_normal((n, 8)).astype(np.float32),
    )
    kw = dict(data_dir=str(tmp_path), eps=1e-3)
    jd = jogb.read_data_ogb("ogbl-citation2", cache_dir=str(tmp_path / "j"),
                            **kw)
    td = togb.read_data_ogb("ogbl-citation2",
                            cache_dir=str(tmp_path / "t"), device="cpu",
                            **kw)
    assert td.metric == "MRR" and td.valid_neg.shape == (20, 9)
    _same_dataset(jd, td)


def test_missing_npz_without_ogb_names_the_fallback(tmp_path):
    with pytest.raises(ImportError, match="export_ogb_npz"):
        togb.read_data_ogb("ogbl-ddi", data_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ppr_cache_read_across_packages(tmp_path, writer):
    """A cache one package writes is what the other reads: the reader is
    handed no edges, so it could not compute the matrix itself."""
    rng = np.random.default_rng(0)
    e = jsyn.random_edges(rng, 50, 200)
    s = np.concatenate([e[:, 0], e[:, 1]])
    d = np.concatenate([e[:, 1], e[:, 0]])
    write, read = ((jppr.get_ppr, tppr.get_ppr) if writer == "jax"
                   else (tppr.get_ppr, jppr.get_ppr))
    w = write("tiny", s, d, 50, 0.15, 1e-3, True, cache_dir=str(tmp_path))
    files = [p.name for p in tmp_path.iterdir()]
    assert files == ["sparse_adj-015_eps-0001_val.npz"]
    none = np.zeros(0, np.int64)
    r = read("tiny", none, none, 50, 0.15, 1e-3, True,
             cache_dir=str(tmp_path))
    assert r.num_nodes == w.num_nodes == 50
    for f in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(r, f), getattr(w, f),
                                      err_msg=f)


def test_ppr_cache_default_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(1)
    e = jsyn.random_edges(rng, 30, 80)
    tppr.get_ppr("somegraph", e[:, 0], e[:, 1], 30, 0.15, 5e-05)
    assert (tmp_path / "node_subsets" / "ppr" / "somegraph"
            / "sparse_adj-015_eps-5e-05.npz").is_file()
