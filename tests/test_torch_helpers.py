"""The port's single-device helpers against lpformer_tpu's: the segment
reductions, ``row_search``, the dense PPR oracle, ``export_reference_state``
(and num_heads > 1 parameters across the importer and the checkpoints),
``sbm_edges`` and the synthetic dataset's ``communities`` /
``ppr_cache_dir`` options; and ``utils/debug.py`` and
``utils/profiling.py`` on CPU tensors.

Integer results and the numpy draws must be identical; float32 reductions
agree to rtol 1e-6 / atol 1e-7 (summation order only, as
tests/test_torch_model.py's masked softmax); parameters cross bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data import synthetic as jsyn
from lpformer_tpu.graph import ppr as jppr
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.ops import search as jsearch
from lpformer_tpu.ops import segment as jseg
from lpformer_tpu.utils import checkpoint as jckpt
from lpformer_tpu.utils import interop as jinterop
from lpformer_tpu_torch.data import synthetic as tsyn
from lpformer_tpu_torch.graph import ppr as tppr
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import search as tsearch
from lpformer_tpu_torch.ops import segment as tseg
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.utils import checkpoint as tckpt
from lpformer_tpu_torch.utils import debug, profiling
from lpformer_tpu_torch.utils import interop as tinterop
from lpformer_tpu_torch.utils.params import from_jax_params

RED = dict(rtol=1e-6, atol=1e-7)


def _segments(seed, length=60, segments=9, heads=None):
    rng = np.random.default_rng(seed)
    shape = (length,) if heads is None else (length, heads)
    x = (rng.standard_normal(shape) * 5).astype(np.float32)
    ids = np.sort(rng.integers(0, segments, length))
    ids[ids == 4] = 5            # segment 4 empty
    valid = rng.random(length) < 0.7
    valid[ids == 2] = False      # segment 2 all invalid
    return x, ids, valid


@pytest.mark.parametrize("heads", [None, 3])
def test_segment_ops_match(heads):
    x, ids, valid = _segments(heads or 1, heads=heads)
    n = 9
    got = tseg.segment_sum(torch.as_tensor(x), torch.as_tensor(ids), n)
    want = jseg.segment_sum(jnp.asarray(x), jnp.asarray(ids), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RED)
    assert not got[4].any()
    for v in (None, valid):
        got = tseg.segment_softmax(
            torch.as_tensor(x), torch.as_tensor(ids), n,
            None if v is None else torch.as_tensor(v))
        want = jseg.segment_softmax(
            jnp.asarray(x), jnp.asarray(ids), n,
            None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RED)
        if v is not None:
            assert not got[torch.as_tensor(~v)].any()   # incl. segment 2
    b = (np.random.default_rng(2).random((5, 7)) < 0.5)
    b[3] = False
    got = tseg.masked_count(torch.as_tensor(b))
    assert got.dtype == torch.float32 and got.shape == (5, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jseg.masked_count(jnp.asarray(b))))


def test_row_search_matches():
    rng = np.random.default_rng(0)
    rows = np.sort(rng.choice(1000, (6, 40), replace=True), axis=1)
    rows[2] = 1000                               # an all-pad row
    queries = np.concatenate(
        [rows[:, ::3], rng.integers(-5, 1010, (6, 20)),
         np.full((6, 2), 1000), np.full((6, 1), -1)], axis=1)
    found, pos = tsearch.row_search(torch.as_tensor(rows),
                                    torch.as_tensor(queries))
    j_found, j_pos = jsearch.row_search(jnp.asarray(rows),
                                        jnp.asarray(queries))
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    assert found[:, :14].all()


def test_ppr_dense_oracle_matches_and_bounds_the_push():
    rng = np.random.default_rng(3)
    e = jsyn.random_edges(rng, 40, 120)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    got = tppr.ppr_dense_oracle(src, dst, 40)
    want = jppr.ppr_dense_oracle(src, dst, 40)
    assert got.dtype == np.float64 and got.shape == (40, 40)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    # the push approximates the fixed point from below, within its
    # residual bound alpha-scaled: every entry <= the oracle's, and the
    # mass it misses per source is at most eps * (number of edges)
    csr = tppr.ppr_push_csr(src, dst, 40, 0.15, 1e-5, method="numpy")
    dense = np.zeros((40, 40))
    rows = np.repeat(np.arange(40), np.diff(csr.indptr))
    dense[rows, csr.indices] = csr.weights
    assert (dense <= got + 1e-6).all()
    assert np.abs(dense - got).sum(1).max() < 1e-5 * len(src)


MODES = {"all": (1e-2, 1e-2), "1-hop": (1e-2, 1), "cn": (1, 1)}


@pytest.mark.parametrize("mode,heads,tlayers", [
    ("all", 2, 1), ("1-hop", 4, 1), ("cn", 1, 2)])
def test_export_reference_state_matches_jax(mode, heads, tlayers):
    """The port's export of from_jax_params(p) equals the JAX export of p
    key for key and leaf for leaf; import inverts it; and the imported
    tree carries num_heads > 1 (att [H, O]) across."""
    t1, tn = MODES[mode]
    cfg = JConfig(dim=8, gnn_layers=2, thresh_1hop=t1, thresh_non1hop=tn,
                  num_heads=heads, trans_layers=tlayers)
    jp = jlt.init_lpformer(jax.random.PRNGKey(1), cfg, in_dim=6)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    want = jinterop.export_reference_state(jax.tree.map(np.asarray, jp))
    got = tinterop.export_reference_state(tp)
    assert list(got) == list(want) == ["model", "score_func"]
    for part in got:
        assert list(got[part]) == list(want[part])
        for k, v in got[part].items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), want[part][k],
                                          err_msg=k)
    assert got["model"]["att_layers.0.att.att"].shape[:2] == (1, heads)
    back = tinterop.import_reference_state(got, device="cpu")
    for (pa, a), (pb, b) in zip(toptim.tree_leaves_with_path(back),
                                toptim.tree_leaves_with_path(tp)):
        assert pa == pb and torch.equal(a, b), pa


def test_multi_head_checkpoint_crosses_both_ways(tmp_path):
    cfg = TConfig(dim=8, gnn_layers=2, num_heads=2, budget_combined=16)
    tp = tlt.init_lpformer(torch.Generator().manual_seed(0), cfg, 6,
                           device="cpu")
    path = str(tmp_path / "m.ckpt")
    tckpt.save_checkpoint(path, {"params": tp})
    jcfg = JConfig(dim=8, gnn_layers=2, num_heads=2, budget_combined=16)
    target = {"params": jlt.init_lpformer(jax.random.PRNGKey(0), jcfg, 6)}
    loaded = jckpt.load_checkpoint(path, target=target)["params"]
    jleaves = jax.tree_util.tree_leaves(loaded)
    tleaves = toptim.tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jckpt.save_checkpoint(path, {"params": loaded})
    again = tckpt.load_checkpoint(path, target={"params": tp})["params"]
    for a, b in zip(toptim.tree_leaves(again), tleaves):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,intra", [(3, 0.85), (7, 0.5)])
def test_sbm_edges_identical(k, intra):
    want = jsyn.sbm_edges(np.random.default_rng(k), 101, 500, k, intra)
    got = tsyn.sbm_edges(np.random.default_rng(k), 101, 500, k, intra)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] != got[:, 1]).all()
    # most edges stay inside a community
    assert ((got[:, 0] % k) == (got[:, 1] % k)).mean() > intra * 0.9


def test_community_dataset_and_ppr_cache_match(tmp_path):
    """communities + the PPR cache: the port writes the cache, the JAX
    package reads it (and rebuilds nothing); splits, features and the
    PPR rows are identical."""
    kw = dict(seed=4, num_nodes=70, num_train=260, num_eval=20, feat_dim=5,
              eps=1e-3, communities=3, intra_frac=0.8, power=1.1)
    td = tsyn.synthetic_dataset(**kw, ppr_cache_dir=str(tmp_path),
                                ppr_method="numpy", device="cpu")
    key = "synthetic-s4-n70-e260-p1.1-k3-i0.8"
    files = os.listdir(tmp_path / key)
    assert files == ["sparse_adj-015_eps-0001.npz"]
    real = jppr.ppr_push_csr
    jppr.ppr_push_csr = None      # a cache miss on the JAX side would fail
    try:
        jd = jsyn.synthetic_dataset(**kw, ppr_cache_dir=str(tmp_path))
    finally:
        jppr.ppr_push_csr = real
    for f in ("train_pos", "train_pos_val", "valid_pos", "valid_neg",
              "test_pos", "test_neg"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    np.testing.assert_array_equal(td.graph.x.numpy(), np.asarray(jd.graph.x))
    np.testing.assert_array_equal(td.graph.ppr_rows.nbrs.numpy(),
                                  np.asarray(jd.graph.ppr_rows.nbrs))
    np.testing.assert_array_equal(td.graph.ppr_rows.vals.numpy(),
                                  np.asarray(jd.graph.ppr_rows.vals))


def test_debug_checks(monkeypatch, capsys):
    tree = {"a": [torch.ones(3), {"w": torch.tensor([1.0, float("nan")])}],
            "n": torch.tensor([1, 2])}
    with pytest.raises(FloatingPointError, match=r"params\['a'\]\[1\]\['w'\]"):
        debug.assert_tree_finite(tree, "params")
    debug.assert_tree_finite({"a": torch.ones(2), "i": torch.arange(3)})
    x = torch.tensor([1.0, float("inf")])
    monkeypatch.delenv("LPFORMER_TPU_DEBUG_NANS", raising=False)
    assert not debug.nan_checks_enabled()
    assert debug.debug_check_finite(x, "h") is x
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("LPFORMER_TPU_DEBUG_NANS", "1")
    assert debug.nan_checks_enabled()
    assert debug.debug_check_finite(x, "h") is x
    assert capsys.readouterr().out == "NaN-check h: non_finite=True\n"
    was = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        w = torch.tensor([0.0], requires_grad=True)
        with pytest.warns(UserWarning, match="anomaly"):
            with pytest.raises(RuntimeError, match="nan"):
                torch.sqrt(w - 1.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_profiling_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
    # the spans are in the exported trace, inner within outer
    span = {e["name"]: e for e in events if e.get("name") in ("outer",
                                                              "inner")}
    assert set(span) == {"outer", "inner"}
    o, i = span["outer"], span["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert all(callable(getattr(profiling, n)) for n in (
        "span", "count", "snapshot", "reset", "active", "trace"))
