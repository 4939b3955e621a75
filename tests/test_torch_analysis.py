"""The port's evalx/analysis.py against lpformer_tpu's: common-neighbour
counts per link, Hits binned by them, and the attention weights behind
``--dump-att``, on the same planted-partition synthetic dataset (4
communities, so the test links' CN counts spread over several bins) and
the same parameters, the JAX side on its dense route
(``use_pallas_attention=False``).

CN counts are exact integers on both sides and must be equal. Scores
agree to rtol 5e-4 / atol 5e-5 (tests/test_torch_model.py); the binned
Hits compare scores against the k-th negative, and on this draw no
positive lies that close to it, so the bins' counts and Hits are equal
(1e-6). alpha is held to the same f32 tolerance.
"""
import dataclasses

import jax
import numpy as np
import pytest

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.evalx import analysis as janalysis
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.evalx import analysis as tanalysis
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.utils.params import from_jax_params

KW = dict(seed=1, num_nodes=160, num_train=900, num_eval=60, feat_dim=12,
          eps=1e-3, communities=4)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0)
F32 = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


def _model(heads, table):
    common = dict(dim=16, gnn_layers=2, thresh_1hop=1e-3,
                  thresh_non1hop=1e-3, num_heads=heads, **table)
    jcfg = JConfig(**common, **NO_DROP, use_pallas_attention=False)
    jp = jlt.init_lpformer(jax.random.PRNGKey(4), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TConfig(**common), tp


def test_compute_edge_cn_matches(both):
    jd, td = both
    for edges in (jd.test_pos, jd.train_pos[:60]):
        want = janalysis.compute_edge_cn(jd, edges, batch_size=64)
        got = tanalysis.compute_edge_cn(td, edges, batch_size=64)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the planted partition gives the test positives common neighbours
    cn = tanalysis.compute_edge_cn(td, td.test_pos)
    assert len(np.unique(cn)) >= 3


@pytest.mark.parametrize("heads,k", [(2, 5), (1, 100)])
def test_by_cn_bins_matches(both, heads, k):
    """Two heads (the dense route in both packages) at k 5, and one head
    (the port's fused op, JAX's dense route) at the default k 100, which
    exceeds the 60 test negatives (every bin's Hits is then 1.0)."""
    jd, td = both
    jcfg, jp, tcfg, tp = _model(heads, dict(budget_combined=48))
    want = janalysis.test_by_cn_bins(jp, jcfg, jd, batch_size=32, k=k)
    got = tanalysis.test_by_cn_bins(tp, tcfg, td, batch_size=32, k=k)
    assert list(got) == list(want) and len(got) >= 2
    for b in want:
        assert got[b]["n"] == want[b]["n"]
        np.testing.assert_allclose(got[b][f"Hits@{k}"],
                                   want[b][f"Hits@{k}"], rtol=0, atol=1e-6)
    cn = tanalysis.compute_edge_cn(td, td.test_pos)
    assert sum(v["n"] for v in got.values()) == int((cn >= 0).sum())


def test_attention_weights_match(both):
    """Two heads on the combined table (calc_pairwise's weights on every
    table and head count: tests/test_torch_dense_attention.py)."""
    jd, td = both
    jcfg, jp, tcfg, tp = _model(2, dict(budget_combined=48))
    # the flag's value does not matter: weights take the dense route
    tcfg = dataclasses.replace(tcfg, use_pallas_attention=True)
    edges = np.asarray(jd.test_pos)[:40]
    j_ids, j_valid, j_alpha = janalysis.attention_weights(
        jp, jcfg, jd, edges, test_set=True)
    ids, valid, alpha = tanalysis.attention_weights(tp, tcfg, td, edges,
                                                    test_set=True)
    np.testing.assert_array_equal(valid, np.asarray(j_valid))
    np.testing.assert_array_equal(ids[valid], np.asarray(j_ids)[valid])
    assert alpha.shape == valid.shape == (40, j_valid.shape[1])
    np.testing.assert_allclose(alpha, np.asarray(j_alpha), **F32)
    assert (alpha[~valid] == 0).all()
    has = valid.any(1)
    assert has.sum() > 20
    np.testing.assert_allclose(alpha[has].sum(1), 1.0, atol=1e-5)
