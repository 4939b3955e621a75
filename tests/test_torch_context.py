"""The port's context extraction and row lookups against lpformer_tpu's.

The context tables of both layouts, the combined (class-tagged) one and
the classic class-blocked one, must be EXACTLY equal: ids, classes,
validity, counts, overflow and both PPR values, with budgets that hold
every entry and with truncating budgets that exercise the top-(ppr_s +
ppr_t) retention and its tie rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.ops import context as jctx
from lpformer_tpu.ops import search as jsearch
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.ops import context as tctx
from lpformer_tpu_torch.ops import search as tsearch

KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=4,
          eps=1e-3)
MODES = {"all": (1e-3, 1e-3), "1-hop": (1e-3, 1), "cn": (1, 1)}


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


@pytest.mark.parametrize("budget", [96, 4])
@pytest.mark.parametrize("mode", ["all", "1-hop", "cn"])
def test_extract_context_identical(both, mode, budget):
    jd, td = both
    t1, tn = MODES[mode]
    kw = dict(thresh_cn=0.0, thresh_1hop=t1, thresh_non1hop=tn,
              budget_combined=budget)
    jcfg = jctx.ContextConfig.from_thresholds(**kw)
    tcfg = tctx.ContextConfig.from_thresholds(**kw)
    assert jcfg.mask_mode == tcfg.mask_mode == mode
    # every valid positive and negative of the split, plus a (u, u) pair
    links = np.concatenate([jd.valid_pos, jd.valid_neg, [[5, 5]]])
    j = jctx.extract_context(
        jd.graph.adj_rows, jd.graph.ppr_rows, jnp.asarray(links[:, 0]),
        jnp.asarray(links[:, 1]), jcfg, train=False)
    t = tctx.extract_context(
        td.graph.adj_rows, td.graph.ppr_rows, torch.as_tensor(links[:, 0]),
        torch.as_tensor(links[:, 1]), tcfg)
    for f in ("ids", "cls", "valid", "counts", "overflow", "src_ppr",
              "tgt_ppr"):
        np.testing.assert_array_equal(
            np.asarray(getattr(j, f)), getattr(t, f).numpy(), err_msg=f)
    if budget == 4:
        assert t.overflow.sum() > 0, "the small budget must truncate"
    else:
        assert t.overflow.sum() == 0


@pytest.mark.parametrize("budgets", [(48, 96, 96), (2, 3, 4)])
@pytest.mark.parametrize("mode", ["all", "1-hop", "cn"])
def test_extract_context_classic_identical(both, mode, budgets):
    """The classic table: each class compacted into its own block of its
    own budget, [cn | 1-hop | >1-hop] (the active classes only); with
    budgets of 2 / 3 / 4, below the counts, overflow sums the classes'
    drops."""
    jd, td = both
    t1, tn = MODES[mode]
    kw = dict(thresh_cn=0.0, thresh_1hop=t1, thresh_non1hop=tn,
              budget_cn=budgets[0], budget_onehop=budgets[1],
              budget_non1hop=budgets[2])
    jcfg = jctx.ContextConfig.from_thresholds(**kw)
    tcfg = tctx.ContextConfig.from_thresholds(**kw)
    assert jcfg.total_budget == tcfg.total_budget == sum(
        tcfg.class_budgets)
    links = np.concatenate([jd.valid_pos, jd.valid_neg, [[5, 5]]])
    j = jctx.extract_context(
        jd.graph.adj_rows, jd.graph.ppr_rows, jnp.asarray(links[:, 0]),
        jnp.asarray(links[:, 1]), jcfg, train=False)
    t = tctx.extract_context(
        td.graph.adj_rows, td.graph.ppr_rows, torch.as_tensor(links[:, 0]),
        torch.as_tensor(links[:, 1]), tcfg)
    assert t.ids.shape == (len(links), tcfg.total_budget)
    for f in ("ids", "cls", "valid", "counts", "overflow", "src_ppr",
              "tgt_ppr"):
        np.testing.assert_array_equal(
            np.asarray(getattr(j, f)), getattr(t, f).numpy(), err_msg=f)
    if budgets[0] == 2:
        assert t.overflow.sum() > 0, "the small budgets must truncate"
    else:
        assert t.overflow.sum() == 0


@pytest.mark.parametrize("budget", [3, 7, 30])
def test_compact_tie_rule_identical(budget):
    """Scores from a 3-value set, so most rows have ties at the cut."""
    rng = np.random.default_rng(budget)
    b, i, n = 16, 24, 1000
    ids = rng.permutation(n)[: b * i].reshape(b, i).astype(np.int32)
    cls = rng.integers(1, 4, (b, i)).astype(np.int32)
    ps = rng.choice(np.float32([0.1, 0.2, 0.3]), (b, i))
    pt = rng.choice(np.float32([0.0, 0.1]), (b, i))
    valid = rng.random((b, i)) < 0.7
    j = jctx._compact(*(jnp.asarray(a) for a in (ids, cls, ps, pt, valid)),
                      budget, n)
    t = tctx._compact(*(torch.as_tensor(a) for a in (ids, cls, ps, pt, valid)),
                      budget, n)
    for name, a, c in zip(("ids", "cls", "ps", "pt", "valid", "dropped"),
                          j, t):
        np.testing.assert_array_equal(np.asarray(a), c.numpy(), err_msg=name)


def test_row_lookups_identical():
    rng = np.random.default_rng(1)
    n, b, k, q = 50, 6, 9, 12
    rows = np.full((b, k), n, np.int32)
    vals = np.zeros((b, k), np.float32)
    for i in range(b):
        m = rng.integers(0, k + 1)
        rows[i, :m] = np.sort(rng.choice(n, m, replace=False))
        vals[i, :m] = rng.random(m)
    queries = rng.integers(0, n + 1, (b, q)).astype(np.int32)  # incl. pads
    jr, jq, jv = jnp.asarray(rows), jnp.asarray(queries), jnp.asarray(vals)
    tr, tq, tv = (torch.as_tensor(rows), torch.as_tensor(queries),
                  torch.as_tensor(vals))
    np.testing.assert_array_equal(
        np.asarray(jsearch.row_contains(jr, jq)),
        tsearch.row_contains(tr, tq).numpy())
    np.testing.assert_array_equal(
        np.asarray(jsearch.row_lookup_value(jr, jv, jq)),
        tsearch.row_lookup_value(tr, tv, tq).numpy())
    jf, (jval,) = jsearch.row_member_values(jr, jq, (jv,), (-1.0,))
    tf, (tval,) = tsearch.row_member_values(tr, tq, (tv,), (-1.0,))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jval), tval.numpy())
