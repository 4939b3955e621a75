"""The ppa-like slice against the JAX package and its sources: the presets
(``presets.PPA_LIKE_*``) against bench.py's "ppa-like" preset and the
synthetic-data settings its main() builds, read from the files; one
training step with the residual GCN over a BlockedBELL of kb 5 (the
preset's tile grid, at a block of 64 on 300 nodes, as
tests/test_torch_blocked.py builds its tiles), on the combined table and on
the classic table with the pairwise block rematerialised; and
``measure.ppa_like_dataset`` at a tiny size, whose negatives, name and
metric route ``run_eval`` to ``test_standard`` with Hits@100, held against
the JAX package's ``test_standard`` on the same parameters.

Tolerances, float32, those of tests/test_torch_train.py: the loss rtol
1e-5, every gradient leaf rtol 5e-4 / atol 5e-5; the sweep's metrics, which
compare scores that agree to rtol 5e-4, 1e-6 (no score lies that close to
another: tests/test_torch_eval_citation2.py).
"""
import ast
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.evalx import harness as jharness
from lpformer_tpu.graph import containers as jcont
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.ops import masking as jmask
from lpformer_tpu.train import step as jstep
from lpformer_tpu_torch import presets
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.graph import containers as tcont
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops import spmm as tspmm
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.train import trainer as ttrainer
from lpformer_tpu_torch.utils import measure
from lpformer_tpu_torch.utils.params import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
# 300 nodes in blocks of 64: kb = 5, the ppa-like preset's grid
KW = dict(seed=1, num_nodes=300, num_train=1500, num_eval=24, feat_dim=12,
          eps=1e-3)
BLOCK = 64
COMMON = dict(dim=16, gnn_layers=3, residual=True, thresh_cn=0.0,
              thresh_1hop=1e-3, thresh_non1hop=1e-3, budget_combined=32,
              **NO_DROP)
TABLES = {"combined": {},
          "classic_remat": dict(budget_combined=None, budget_cn=8,
                                budget_onehop=16, budget_non1hop=16,
                                remat_pairwise=True)}
B = 48


# --------------------------------------------------------------------------
# the presets, read from bench.py and configs/ogbl-ppa-existing.json
# --------------------------------------------------------------------------

def _bench_main_call(func_name):
    """The keyword expressions of the call to ``func_name`` in bench.py's
    main() (its one ``synthetic_dataset(...)`` / ``LPFormerConfig(...)``),
    as source strings."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == func_name]
    assert len(calls) == 1, func_name
    return {k.arg: ast.unparse(k.value) for k in calls[0].keywords}


def _bench_preset():
    """bench.PRESETS["ppa-like"] (the module's top level imports nothing
    heavy; main() is not run)."""
    import bench

    return bench.PRESETS["ppa-like"]


def _bench_args(p):
    """bench.py's parsed args as main() sets them from the preset, outside
    --smoke, with the defaults of the flags the calls read."""
    return types.SimpleNamespace(
        smoke=False, nodes=p["nodes"], edges=p["edges"], feat=p["feat"],
        dim=p["dim"], batch=p["batch"], mask_input=False, ppr_cache="",
        pallas=None, bf16=True)


def _eval_call(func_name, env):
    return {k: eval(src, {}, env)   # noqa: S307 - bench.py's own source
            for k, src in _bench_main_call(func_name).items()}


def _ppa_json():
    with open(os.path.join(ROOT, "configs", "ogbl-ppa-existing.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("table", ["combined", "classic"])
def test_preset_config_is_the_bench_preset(table):
    """PPA_LIKE_CONFIG is bench.py's LPFormerConfig(...) call at the
    "ppa-like" preset (its --no-combined A/B for the classic table), with
    residual from configs/ogbl-ppa-existing.json; the JAX package's config
    of the same fields equals it field by field."""
    p = _bench_preset()
    env = dict(args=_bench_args(p), budgets=p["budgets"],
               gnn_layers=p["gnn_layers"],
               combined=p["combined"] if table == "combined" else None)
    kw = _eval_call("LPFormerConfig", env)
    want = dataclasses.asdict(JConfig(**kw, residual=_ppa_json()["residual"]))
    got = (presets.PPA_LIKE_CONFIG if table == "combined"
           else presets.PPA_LIKE_CLASSIC_CONFIG)
    assert dataclasses.asdict(got) == want
    assert got.residual is True and got.matmul_dtype == "bfloat16"


def test_preset_data_and_batch_are_the_bench_settings():
    """PPA_LIKE_DATA is bench.py's synthetic_dataset(...) call at the
    preset's sizes (its PPR cache directory aside), PPA_LIKE_BATCH the
    preset's batch; the classic table's remat turns on by the JAX rule
    (B * C * dim * 4 bytes over 2e9) and the combined table's does not."""
    p = _bench_preset()
    kw = _eval_call("synthetic_dataset", dict(args=_bench_args(p)))
    kw.pop("ppr_cache_dir")
    assert kw.pop("mask_input") is False
    assert presets.PPA_LIKE_DATA == kw
    assert presets.PPA_LIKE_BATCH == p["batch"]
    c = presets.PPA_LIKE_CLASSIC_CONFIG
    assert tlt.remat_pairwise_on(c, p["batch"], sum(c.context.class_budgets))
    assert not tlt.remat_pairwise_on(presets.PPA_LIKE_CONFIG, p["batch"],
                                     p["combined"])


# --------------------------------------------------------------------------
# the residual step over the BlockedBELL, on both tables
# --------------------------------------------------------------------------

def _tiled(graph, cont):
    s, d = np.asarray(graph.edge_src), np.asarray(graph.edge_dst)
    bb = cont.BlockedBELL.from_coo(s, d, graph.num_nodes,
                                   np.asarray(graph.w_norm), block=BLOCK)
    return dataclasses.replace(graph, ell=None, bbell=bb)


@pytest.fixture(scope="module")
def tiled():
    jd, td = jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")
    jg, tg = _tiled(jd.graph, jcont), _tiled(td.graph, tcont).to("cpu")
    assert tg.bbell.kb == 5 and jg.bbell.kb == 5
    return jd, jg, tg


@pytest.mark.parametrize("table", list(TABLES))
def test_residual_step_on_bbell_matches_jax(tiled, table, monkeypatch):
    """One training step (loss and every gradient leaf) with residual=True,
    3 GCN layers over the kb-5 BlockedBELL, against the JAX package on the
    CPU (its dense attention, jitted): the combined table, and the classic
    table with remat_pairwise=True."""
    jd, jg, tg = tiled
    common = dict(COMMON, **TABLES[table])
    jcfg = JConfig(**common, use_pallas_attention=False)
    jp = jlt.init_lpformer(jax.random.PRNGKey(3), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = TConfig(**common)
    calls = []
    real = tspmm.spmm_bbell
    monkeypatch.setattr(tspmm, "spmm_bbell",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if table == "classic_remat":
        remat = []
        real_remat = tlt._checkpoint_with_generator
        monkeypatch.setattr(
            tlt, "_checkpoint_with_generator",
            lambda *a: remat.append(1) or real_remat(*a))

    rng = np.random.default_rng(10)
    pos = jd.train_pos[rng.choice(len(jd.train_pos), B, replace=False)]
    w = np.ones(B, np.float32)
    w[-5:] = 0.0
    neg = rng.integers(0, KW["num_nodes"], (2, B))
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
    # one propagation a step, one SpMM a layer
    assert len(calls) == COMMON["gnn_layers"]
    if table == "classic_remat":
        assert remat
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
               for p, x in jax.tree_util.tree_leaves_with_path(jgr)]
    assert len(jleaves) == len(grads)
    for (path, want), g, x in zip(jleaves, grads, leaves):
        got = torch.zeros_like(x) if g is None else g
        np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                   **GRAD_TOL)


# --------------------------------------------------------------------------
# ppa_like_dataset and its sweep
# --------------------------------------------------------------------------

SMALL = dict(presets.PPA_LIKE_DATA, num_nodes=120, num_train=500, num_eval=30,
             feat_dim=12, eps=1e-3, adj_cap=32, ppr_cap=32)
NEGATIVES = 400


def test_ppa_like_dataset_negatives_name_and_sweep_match_jax(monkeypatch):
    """At a tiny size: 400 uniform negative pairs a split from
    default_rng(seed), the dataset named and measured so that run_eval
    takes test_standard with Hits@20/50/100 and no MRR, whose metrics equal
    the JAX package's test_standard on the same parameters and negatives."""
    td = measure.ppa_like_dataset("cpu", seed=3, data=SMALL,
                                  negatives=NEGATIVES)
    rng = np.random.default_rng(3)
    for split in ("valid_neg", "test_neg"):
        np.testing.assert_array_equal(
            getattr(td, split), rng.integers(0, SMALL["num_nodes"],
                                             (NEGATIVES, 2)))
    assert td.metric == "Hits@100" and "citation" not in td.name.lower()
    assert not td.heart

    jd = jax_synthetic(**{k: v for k, v in SMALL.items()
                          if k not in ("adj_cap", "ppr_cap")},
                       adj_cap=SMALL["adj_cap"], ppr_cap=SMALL["ppr_cap"],
                       metric="Hits@100")
    jd.valid_neg, jd.test_neg, jd.name = td.valid_neg, td.test_neg, td.name
    np.testing.assert_array_equal(jd.train_pos, td.train_pos)

    common = dict(dim=16, gnn_layers=3, residual=True, budget_combined=32,
                  thresh_1hop=1e-3, thresh_non1hop=1e-3)
    jcfg = JConfig(**common, use_pallas_attention=False)
    jp = jlt.init_lpformer(jax.random.PRNGKey(5), jcfg,
                           in_dim=SMALL["feat_dim"])
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    seen = []
    real = ttrainer.harness.test_standard
    monkeypatch.setattr(ttrainer.harness, "test_standard",
                        lambda *a, **k: seen.append(k) or real(*a, **k))
    t = ttrainer.run_eval(tp, TConfig(**common), td,
                          ttrainer.TrainArgs(test_batch_size=64))
    j = jharness.test_standard(jp, jcfg, jd, batch_size=64)
    assert len(seen) == 1 and seen[0]["heart"] is False
    assert sorted(t) == ["Hits@100", "Hits@20", "Hits@50"]
    assert t.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_bwd_f64_holds_the_plain_sums(dtype):
    """measure.mixed_bwd_f64, the witness chip_smoke.py holds row 2's
    per-class weight grads to: its f64 sums of the combined plain
    backward's own f32 terms equal the plain's dw1cat, dg, db and dcb
    within the bound of any order of f32 additions, (n - 1) 2^-24 of the
    terms' magnitudes, and the magnitudes bound the sums."""
    from lpformer_tpu_torch.ops import pe_attention_mixed as tpam

    a = measure.bwd_inputs(measure.kernel_inputs(
        "cpu", dtype, b=64, c=32, o=16, dh=16))
    got = tpam.fused_pe_link_attention_mixed_bwd_plain(**a)
    wit = measure.mixed_bwd_f64(**a)
    n = a["valid"].numel() * 2
    for i, ex, mag in zip((2, 3, 4, 6), wit[:4], wit[4:]):
        assert ex.shape == got[i].shape
        assert bool((ex.abs() <= mag * (1 + 1e-12)).all())
        err = (got[i].double() - ex).abs()
        assert bool((err <= (n - 1) * 2.0 ** -24 * mag).all())
        assert float(mag.max()) > 0
