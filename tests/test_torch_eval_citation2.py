"""The port's per-positive evaluation against lpformer_tpu's: the metrics
(Hits, per-positive MRR ranks, sample-level hits, the citation2 score,
AUC / AP), test_standard with HeaRT negatives, test_citation2, run_eval's
dispatch, the trainer's loggers, and train_loop on a HeaRT dataset.

Metrics take the same score arrays in both packages and must agree to
float32 rounding (1e-6), ties included; AUC / AP are float64 and rounded
to 4 places on both sides, so they are equal. The harnesses run on the
same tiny synthetic dataset and parameters in both packages (the JAX side
on its dense path, float32); its scores agree within rtol 5e-4 / atol
5e-5 (tests/test_torch_model.py), and the metrics, which compare scores,
come out equal (1e-6) because no score lies that close to another.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.evalx import harness as jharness
from lpformer_tpu.evalx import metrics as jmetrics
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.train import trainer as jtrainer
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.evalx import harness as tharness
from lpformer_tpu_torch.evalx import metrics as tmetrics
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.train import trainer as ttrainer
from lpformer_tpu_torch.utils.params import from_jax_params

KW = dict(seed=2, num_nodes=90, num_train=320, num_eval=30, feat_dim=12,
          eps=1e-3)
COMMON = dict(dim=16, gnn_layers=2, thresh_1hop=1e-3, thresh_non1hop=1e-3,
              budget_combined=32)


def _grid(rng, *shape):
    """Scores on a coarse grid, so positives tie with negatives and with
    each other."""
    return (rng.integers(0, 20, shape) / 20).astype(np.float32)


def _close(j, t, name):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=1e-6, err_msg=name)


def _dicts_close(j, t):
    assert j.keys() == t.keys()
    for k in j:
        _close(j[k], t[k], k)


@pytest.mark.parametrize("n_neg", [7, 150])
def test_shared_negative_metrics_match_jax(n_neg):
    """evaluate_hits and evaluate_hits_single (sorted once, or not) and
    sample_level_hits against shared negatives; 7 negatives is fewer than
    every K past 7 (Hits = 1.0)."""
    rng = np.random.default_rng(n_neg)
    pos, neg = _grid(rng, 40), _grid(rng, n_neg)
    jp, jn = jnp.asarray(pos), jnp.asarray(neg)
    tp, tn = torch.as_tensor(pos), torch.as_tensor(neg)
    ks = (1, 5, 20, 50, 100)
    _dicts_close(jmetrics.evaluate_hits(jp, jn, ks),
                 tmetrics.evaluate_hits(tp, tn, ks))
    for k in ks:
        want = float(jmetrics.evaluate_hits_single(jp, jn, k))
        assert tmetrics.evaluate_hits_single(tp, tn, k) == pytest.approx(
            want, abs=1e-6)
        assert tmetrics.evaluate_hits_single(
            tp, torch.sort(tn).values, k, neg_sorted=True) == pytest.approx(
            want, abs=1e-6)
    _dicts_close(jmetrics.sample_level_hits(jp, jn),
                 tmetrics.sample_level_hits(tp, tn))


@pytest.mark.parametrize("k", [7, 150])
def test_per_positive_metrics_match_jax(k):
    """mrr_ranks, evaluate_mrr, sample_level_hits and
    get_metric_score_citation2 against [P, K] negatives with ties; K = 7
    is fewer than Hits@10/50/100's K."""
    rng = np.random.default_rng(k + 1)
    arrays = [_grid(rng, 30), _grid(rng, 30), _grid(rng, 30, k),
              _grid(rng, 25), _grid(rng, 25, k)]
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.as_tensor(a) for a in arrays]
    _close(jmetrics.mrr_ranks(j[1], j[2]), tmetrics.mrr_ranks(t[1], t[2]),
           "mrr_ranks")
    _dicts_close(jmetrics.evaluate_mrr(j[1], j[2]),
                 tmetrics.evaluate_mrr(t[1], t[2]))
    _dicts_close(jmetrics.sample_level_hits(j[3], j[4]),
                 tmetrics.sample_level_hits(t[3], t[4]))
    _dicts_close(jmetrics.get_metric_score_citation2(*j),
                 tmetrics.get_metric_score_citation2(*t))


@pytest.mark.parametrize("case", ["ties", "distinct", "one_class"])
def test_auc_matches_jax(case):
    rng = np.random.default_rng(3)
    pred = (_grid(rng, 200) if case == "ties"
            else rng.random(200).astype(np.float32))
    true = (rng.random(200) < 0.3).astype(np.float32)
    if case == "one_class":
        true[:] = 1.0
    want = jmetrics.evaluate_auc(jnp.asarray(pred), jnp.asarray(true))
    assert tmetrics.evaluate_auc(torch.as_tensor(pred),
                                 torch.as_tensor(true)) == want
    assert tmetrics.evaluate_auc(pred, true) == want


def _pair(heart=False, citation=False):
    """The same synthetic dataset in both packages, with HeaRT negatives
    or [P, 7] citation2 target ids, and the same parameters."""
    kw = dict(KW, heart=heart, heart_negs=6) if heart else KW
    jd, td = jax_synthetic(**kw), synthetic_dataset(**kw, device="cpu")
    if citation:
        rng = np.random.default_rng(4)
        for ds in (jd, td):
            ds.name = "synthetic-citation2-like"
        jd.valid_neg = td.valid_neg = rng.integers(0, 90, (30, 7))
        jd.test_neg = td.test_neg = rng.integers(0, 90, (30, 7))
    jcfg = JConfig(**COMMON, dropout=0.0, gnn_drop=0.0, att_drop=0.0,
                   use_pallas_attention=False)
    jp = jlt.init_lpformer(jax.random.PRNGKey(5), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jd, td, jcfg, TConfig(**COMMON), jp, tp


def test_heart_negatives_equal_jax():
    jd, td = _pair(heart=True)[:2]
    assert td.heart and td.valid_neg.shape == (30, 6, 2)
    for name in ("train_pos", "valid_pos", "valid_neg", "test_neg"):
        np.testing.assert_array_equal(getattr(jd, name), getattr(td, name))
    np.testing.assert_array_equal(np.asarray(jd.graph.x), td.graph.x.numpy())


def test_standard_heart_matches_jax():
    jd, td, jcfg, tcfg, jp, tp = _pair(heart=True)
    j = jharness.test_standard(jp, jcfg, jd, batch_size=16, heart=True)
    t = tharness.test_standard(tp, tcfg, td, batch_size=16, heart=True)
    assert list(t) == ["MRR"]
    _dicts_close(j, t)


def test_citation2_matches_jax():
    jd, td, jcfg, tcfg, jp, tp = _pair(citation=True)
    j = jharness.test_citation2(jp, jcfg, jd, batch_size=64)
    t = tharness.test_citation2(tp, tcfg, td, batch_size=64)
    _dicts_close(j, t)
    # the reference's quirk: the train slot is the valid one
    assert t["MRR"][0] == t["MRR"][1]


@pytest.mark.parametrize("kind", ["plain", "heart", "citation",
                                  "citation_heart"])
def test_run_eval_dispatches_like_jax(kind, monkeypatch):
    """A citation dataset without HeaRT negatives takes test_citation2;
    any other test_standard with the dataset's heart flag; the same call
    in both packages."""
    seen = {}

    def record(pkg, name):
        def fn(params, cfg, ds, **kw):
            seen[pkg] = (name, kw.get("heart", False))
            return {}
        return fn

    for pkg, mod in (("jax", jharness), ("torch", tharness)):
        monkeypatch.setattr(mod, "test_citation2", record(pkg, "citation2"))
        monkeypatch.setattr(mod, "test_standard", record(pkg, "standard"))
    td = synthetic_dataset(**dict(KW, num_nodes=40, num_train=100),
                           device="cpu")
    td.heart = kind in ("heart", "citation_heart")
    if kind.startswith("citation"):
        td.name = "ogbl-citation2"
    jtrainer.run_eval(None, None, td, jtrainer.TrainArgs())
    ttrainer.run_eval(None, None, td, ttrainer.TrainArgs())
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == (("citation2", False) if kind == "citation"
                             else ("standard", td.heart))


@pytest.mark.parametrize("kind", ["heart", "citation"])
def test_train_data_loggers_match_jax(kind, monkeypatch):
    """train_data opens the MRR logger for a HeaRT or citation dataset
    whatever the metric, as the JAX package's does."""
    td = synthetic_dataset(**dict(KW, num_nodes=40, num_train=100),
                           device="cpu")
    td.heart = kind == "heart"
    if kind == "citation":
        td.name = "ogbl-citation2"
    seen = {}

    def capture(pkg):
        def fn(args, cfg, ds, loggers, seed, *a, **k):
            seen[pkg] = sorted(loggers)
            loggers["Hits@20"].add_result(seed, (0.0, 0.0, 0.0))
            return 0.0
        return fn

    monkeypatch.setattr(jtrainer, "train_loop", capture("jax"))
    monkeypatch.setattr(ttrainer, "train_loop", capture("torch"))
    jtrainer.train_data(jtrainer.TrainArgs(metric="Hits@20", verbose=False),
                        None, td)
    ttrainer.train_data(ttrainer.TrainArgs(metric="Hits@20", verbose=False),
                        None, td)
    assert seen["torch"] == seen["jax"]
    assert "MRR" in seen["torch"]


def test_train_loop_with_heart():
    """One tiny epoch with HeaRT negatives (args.heart no longer refused):
    finite losses and an MRR in [0, 1] from the per-positive sweep."""
    td = synthetic_dataset(**dict(KW, heart=True, heart_negs=4),
                           device="cpu")
    cfg = TConfig(**dict(COMMON, dropout=0.1, gnn_drop=0.1, att_drop=0.1))
    args = ttrainer.TrainArgs(epochs=1, batch_size=128, test_batch_size=64,
                              eval_steps=1, heart=True, verbose=False)
    loggers = {k: ttrainer.ResultsLogger(1) for k in
               ("Hits@20", "Hits@50", "Hits@100", "MRR")}
    losses = []
    best = ttrainer.train_loop(args, cfg, td, loggers, 0, step_losses=losses)
    assert len(losses) == -(-len(td.train_pos) // 128)
    assert all(bool(torch.isfinite(x)) for x in losses)
    (res,) = loggers["MRR"].results[0]
    assert all(0.0 <= v <= 1.0 for v in res)
    assert best == loggers["MRR"].best_valid(0)
    assert not loggers["Hits@20"].results[0]
