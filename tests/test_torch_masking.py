"""The port's rank-space batch masking and train-mode context extraction
against the JAX package, on the same synthetic graph (numpy draws from the
same seed in both packages). Everything here is integer or exact: the
comparisons are exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.ops import masking as jmask
from lpformer_tpu.ops.context import extract_context as jax_extract
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops.context import extract_context

KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)
MODES = {"all": (1e-3, 1e-3), "1-hop": (1e-3, 1), "cn": (1, 1)}


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


@pytest.fixture(scope="module")
def both_capped():
    kw = dict(KW, adj_cap=6)
    return jax_synthetic(**kw), synthetic_dataset(**kw, device="cpu")


def _batch(ds, seed=0):
    """A batch of train positives with duplicate edges (the same pair
    twice, and reversed) and zero-weight padding; returns numpy
    (src, tgt, weight)."""
    rng = np.random.default_rng(seed)
    tp = ds.train_pos
    idx = rng.choice(len(tp), 40, replace=False)
    pairs = np.concatenate([tp[idx], tp[idx[:5]], tp[idx[5:9]][:, ::-1],
                            tp[rng.choice(len(tp), 6)]])
    w = np.ones(len(pairs), np.float32)
    w[-6:] = 0.0
    return pairs[:, 0], pairs[:, 1], w


@pytest.mark.parametrize("capped", [False, True])
def test_bundle_ranks_match(both, both_capped, capped):
    jd, td = both_capped if capped else both
    np.testing.assert_array_equal(td.graph.adj_rows.ranks.numpy(),
                                  np.asarray(jd.graph.adj_rows.ranks))
    np.testing.assert_array_equal(td.mask_mult, jd.mask_mult)
    assert td.mask_mult_device.dtype == torch.int32
    # multiplicities above 1 exist, so the duplicate semantics are tested
    assert td.mask_mult.max() > 1


def test_edge_ranks_for_entries_match(both):
    jd, td = both
    rng = np.random.default_rng(1)
    src = rng.integers(0, KW["num_nodes"], 500)
    dst = rng.integers(0, KW["num_nodes"], 500)
    np.testing.assert_array_equal(
        tmask.edge_ranks_for_entries(src, dst, td.mask_uniq_keys,
                                     KW["num_nodes"]),
        jmask.edge_ranks_for_entries(src, dst, jd.mask_uniq_keys,
                                     KW["num_nodes"]))


@pytest.mark.parametrize("capped", [False, True])
def test_batch_mask_ranks_match(both, both_capped, capped):
    jd, td = both_capped if capped else both
    src, tgt, w = _batch(td)
    jr = jmask.link_edge_ranks(
        jd.graph.adj_rows.nbrs[src], jd.graph.adj_rows.ranks[src],
        jnp.asarray(tgt), jd.graph.adj_rows.nbrs[tgt],
        jd.graph.adj_rows.ranks[tgt], jnp.asarray(src))
    ts, tt = torch.as_tensor(src), torch.as_tensor(tgt)
    tr = tmask.link_edge_ranks(
        td.graph.adj_rows.nbrs[ts], td.graph.adj_rows.ranks[ts], tt,
        td.graph.adj_rows.nbrs[tt], td.graph.adj_rows.ranks[tt], ts)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    for weight in (None, w):
        jm = jmask.batch_mask_ranks(
            jd.graph.adj_rows, jnp.asarray(src), jnp.asarray(tgt),
            jd.mask_mult_device,
            weight=None if weight is None else jnp.asarray(weight))
        tm = tmask.batch_mask_ranks(
            td.graph.adj_rows, ts, tt, td.mask_mult_device,
            weight=None if weight is None else torch.as_tensor(weight))
        assert tm.dtype == torch.bool
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert 0 < int(tm.sum()) < len(tm)


def test_rank_is_masked_matches(both):
    jd, td = both
    rng = np.random.default_rng(2)
    u = len(td.mask_mult)
    bitmap = rng.random(u) < 0.3
    ranks = rng.integers(-1, u, (9, 13)).astype(np.int32)
    np.testing.assert_array_equal(
        tmask.rank_is_masked(torch.as_tensor(bitmap),
                             torch.as_tensor(ranks)).numpy(),
        np.asarray(jmask.rank_is_masked(jnp.asarray(bitmap),
                                        jnp.asarray(ranks))))
    empty = tmask.rank_is_masked(torch.zeros(0, dtype=torch.bool),
                                 torch.as_tensor(ranks))
    assert not bool(empty.any())


@pytest.mark.parametrize("mode", ["all", "1-hop", "cn"])
def test_train_context_with_mask_matches(both, mode):
    jd, td = both
    t1, tn = MODES[mode]
    common = dict(thresh_cn=0.0, thresh_1hop=t1, thresh_non1hop=tn,
                  budget_combined=24, att_drop=0.0)
    jcfg, tcfg = JConfig(**common).context, TConfig(**common).context
    src, tgt, w = _batch(td, seed=3)
    jm = jmask.batch_mask_ranks(jd.graph.adj_rows, jnp.asarray(src),
                                jnp.asarray(tgt), jd.mask_mult_device,
                                weight=jnp.asarray(w))
    tm = tmask.batch_mask_ranks(td.graph.adj_rows, torch.as_tensor(src),
                                torch.as_tensor(tgt), td.mask_mult_device,
                                weight=torch.as_tensor(w))
    jc = jax_extract(jd.graph.adj_rows, jd.graph.ppr_rows, jnp.asarray(src),
                     jnp.asarray(tgt), jcfg, mask_ranks=jm, train=True)
    tc = extract_context(td.graph.adj_rows, td.graph.ppr_rows,
                         torch.as_tensor(src), torch.as_tensor(tgt), tcfg,
                         mask_ranks=tm, train=True)
    for f in dataclasses.fields(tc):
        np.testing.assert_array_equal(getattr(tc, f.name).numpy(),
                                      np.asarray(getattr(jc, f.name)),
                                      err_msg=f.name)
    unmasked = extract_context(td.graph.adj_rows, td.graph.ppr_rows,
                               torch.as_tensor(src), torch.as_tensor(tgt),
                               tcfg)
    # the batch's own edges left the context: fewer CNs / 1-hop entries
    assert float(tc.counts[:, 3].sum()) < float(unmasked.counts[:, 3].sum())


def test_attention_subsampling(both):
    """att_drop keeps each candidate with probability 1 - att_drop, before
    the counts; the same generator seed draws the same subsample; without
    a generator, or at eval, nothing is dropped."""
    _, td = both
    cfg = TConfig(thresh_cn=0.0, thresh_1hop=1e-3, thresh_non1hop=1e-3,
                  budget_combined=24, att_drop=0.5).context
    src = torch.as_tensor(td.train_pos[:60, 0])
    tgt = torch.as_tensor(td.train_pos[:60, 1])
    rows = (td.graph.adj_rows, td.graph.ppr_rows, src, tgt, cfg)
    full = extract_context(*rows)
    sub = [extract_context(*rows, gen=torch.Generator().manual_seed(s),
                           train=True) for s in (7, 7, 8)]
    for a, b in zip(dataclasses.astuple(sub[0]), dataclasses.astuple(sub[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(sub[0].counts, sub[2].counts)
    kept = float(sub[0].counts[:, :3].sum()) / float(full.counts[:, :3].sum())
    assert 0.35 < kept < 0.65
    assert bool((sub[0].counts <= full.counts).all())
    for same in (extract_context(*rows, train=True),
                 extract_context(*rows, gen=torch.Generator(), train=False)):
        torch.testing.assert_close(same.counts, full.counts, rtol=0, atol=0)
