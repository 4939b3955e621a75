"""Context parallelism in the port (lpformer_tpu_torch/parallel/
context_parallel.py: the context axis sharded over 'graph', a merged
two-pass softmax) against lpformer_tpu's on the CPU.

The JAX side runs in this process on the virtual CPU devices of
tests/conftest.py; the port runs as 4 gloo ranks, one pool for the whole
module (``torch_mesh_cases.run_cases``), on the (2, 2) and (1, 4) meshes
(g = 2 and 4). Inputs are tests/test_context_parallel.py's: 96 nodes,
dim 16, the classic table of 24 | 48 | 48 and the combined table of 120,
dropout off, negatives injected, the JAX package's parameters.

Tolerances, float32: the loss rtol 2e-5 / atol 1e-6; gradients rtol
5e-4 / atol 5e-5; scores rtol 2e-4 / atol 2e-5; the sliced positional
encodings rtol 1e-5 / atol 1e-6 (one MLP of the same inputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import init_lpformer as jinit
from lpformer_tpu.ops.context import extract_context as jextract
from lpformer_tpu.parallel import context_parallel as jcp
from lpformer_tpu.parallel import make_mesh as jmake_mesh
from lpformer_tpu.parallel import make_sharded_loss as jsharded_loss
from lpformer_tpu.parallel import partition_graph as jpartition
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops.context import ContextTables
from lpformer_tpu_torch.parallel import context_parallel as tcp
from lpformer_tpu_torch.parallel import distributed
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.utils.params import from_jax_params

import torch_mesh_cases

KW = dict(seed=0, num_nodes=96, num_train=320, num_eval=32, feat_dim=12)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
CLASSIC = dict(dim=16, gnn_layers=2, budget_cn=24, budget_onehop=48,
               budget_non1hop=48)
CFGS = {"classic": dict(CLASSIC, **NO_DROP),
        "combined": dict(CLASSIC, budget_combined=120, **NO_DROP),
        "dropout": dict(CLASSIC, dropout=0.2, att_drop=0.2, gnn_drop=0.1,
                        feat_drop=0.1)}
MESHES = [(2, 2), (1, 4)]
CP = {"context_parallel": True}
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
SCORE_TOL = dict(rtol=2e-4, atol=2e-5)
PE_TOL = dict(rtol=1e-5, atol=1e-6)
B = 32
RANKS = 4


def _mesh_name(d, g):
    return f"{d}x{g}"


CASES = (
    [dict(kind="loss", name=f"loss/{t}/{_mesh_name(*m)}", mesh=m, cfg=t,
          kw=CP) for t in ("classic", "combined") for m in MESHES]
    + [dict(kind="eval", name="eval", mesh=(2, 2), cfg="classic", kw=CP),
       dict(kind="descend", name="descend", mesh=(2, 2), cfg="dropout",
            kw=CP),
       dict(kind="loss_seeded", name="dropout", mesh=(2, 2), cfg="dropout",
            kw=CP)])


@pytest.fixture(scope="module")
def jds():
    return jax_synthetic(**KW)


@pytest.fixture(scope="module")
def tds():
    return synthetic_dataset(**KW, device="cpu")


@pytest.fixture(scope="module")
def spec(jds):
    params = jinit(jax.random.PRNGKey(3), JConfig(**CFGS["classic"]),
                   in_dim=12)
    neg = jax.random.randint(jax.random.PRNGKey(7), (2, B), 0, jds.num_nodes,
                             dtype=jnp.int32)
    return dict(data=KW, cfgs=CFGS, cases=CASES,
                params=jax.tree.map(np.asarray, params),
                src=np.asarray(jds.train_pos[:B, 0]).astype(np.int64),
                tgt=np.asarray(jds.train_pos[:B, 1]).astype(np.int64),
                neg=np.asarray(neg).astype(np.int64),
                w=np.ones(B, np.float32))


def _jax_cp(jds, spec, table, d, g):
    """JAX's context-parallel sharded loss and gradients."""
    cfg = JConfig(**CFGS[table])
    mesh = jmake_mesh(data=d, graph=g, devices=jax.devices()[:d * g])
    sg = jpartition(jds.graph, g=g, d=d)
    loss = jsharded_loss(cfg, mesh, jds.num_nodes, sg.rows_per_shard,
                         sg.ctx_rows_per_shard, train=True,
                         context_parallel=True)
    params = jax.tree.map(jnp.asarray, spec["params"])
    src, tgt = (jnp.asarray(spec[k]).astype(jnp.int32) for k in ("src", "tgt"))
    w = jnp.asarray(spec["w"])
    neg = jnp.asarray(spec["neg"]).astype(jnp.int32)
    val, grads = jax.jit(jax.value_and_grad(lambda p: loss(
        p, sg, jds.mask_mult_device, src, tgt, w, neg[0], neg[1], w,
        jax.random.PRNGKey(7))))(params)
    return float(val), [np.asarray(x) for x in jax.tree_util.tree_leaves(
        grads)]


@pytest.fixture(scope="module")
def both_sides(jds, spec):
    """(the pool's results per rank, JAX's CP loss and gradients per
    (table, mesh)); the pool runs while JAX compiles, in threads."""
    from concurrent.futures import ThreadPoolExecutor

    keys = [(t, d, g) for t in ("classic", "combined") for d, g in MESHES]
    with ThreadPoolExecutor(4) as ex:
        ranks = ex.submit(distributed.spawn_local, torch_mesh_cases.run_cases,
                          RANKS, (spec,), device="cpu", timeout_s=600,
                          threads=1)
        futs = [ex.submit(_jax_cp, jds, spec, *k) for k in keys]
        return ranks.result(), dict(zip(keys, (f.result() for f in futs)))


@pytest.fixture(scope="module")
def pool(both_sides):
    return both_sides[0]


def _port_single(tds, spec, table):
    cfg = TConfig(**CFGS[table])
    params = from_jax_params(spec["params"], device="cpu")
    leaves = toptim.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    src, tgt, neg, w = (torch.as_tensor(spec[k])
                        for k in ("src", "tgt", "neg", "w"))
    mr = tmask.batch_mask_ranks(tds.graph.adj_rows, src, tgt,
                                tds.mask_mult_device, weight=w)
    loss = tstep.loss_fn(params, cfg, tds.graph, src, tgt, neg[0], neg[1],
                         w, mr, None)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _mesh_name(*m))
@pytest.mark.parametrize("table", ["classic", "combined"])
def test_cp_loss_matches(both_sides, tds, spec, table, mesh):
    """The CP loss against JAX's CP loss at the same mesh and the port's
    single-device loss; every rank the same."""
    pool, jref = both_sides
    got = [out[f"loss/{table}/{_mesh_name(*mesh)}"]["loss"] for out in pool]
    assert all(x == got[0] for x in got)
    np.testing.assert_allclose(got[0], jref[(table, *mesh)][0], **LOSS_TOL)
    np.testing.assert_allclose(got[0], _port_single(tds, spec, table)[0],
                               **LOSS_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _mesh_name(*m))
@pytest.mark.parametrize("table", ["classic", "combined"])
def test_cp_grads_match(both_sides, tds, spec, table, mesh):
    """Every gradient leaf of the CP loss, summed over the mesh, against
    JAX's and the port's single-device gradients."""
    pool, jref = both_sides
    got = pool[0][f"loss/{table}/{_mesh_name(*mesh)}"]["grads"]
    want = jref[(table, *mesh)][1]
    single = _port_single(tds, spec, table)[1]
    assert len(got) == len(want) == len(single)
    for a, b, c in zip(got, want, single):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
        np.testing.assert_allclose(a, c, **GRAD_TOL)


def test_cp_eval_scores_match_single_device(pool):
    for out in pool:
        got = out["eval"]
        np.testing.assert_allclose(got["got"], got["want"], **SCORE_TOL)
        np.testing.assert_allclose(got["group"], got["want_group"],
                                   **SCORE_TOL)


def test_cp_train_step_descends(pool):
    got = pool[0]["descend"]["losses"]
    assert got[-1] < got[0], got
    for out in pool[1:]:
        for a, b in zip(out["descend"]["params"], pool[0]["descend"]["params"]):
            np.testing.assert_array_equal(a, b)


def test_cp_dropout_paths_run(pool):
    """With every dropout on, the CP loss is finite, the same from two
    calls with one seed, and the same on every rank (the links' draws
    depend on the data index only, so a link's context slices agree)."""
    a, b = pool[0]["dropout"]
    assert np.isfinite(a) and a == b
    assert all(out["dropout"] == [a, b] for out in pool)


@pytest.mark.parametrize("mod", [jcp, tcp], ids=["jax", "port"])
def test_cp_rejects_indivisible_budgets(mod):
    cfg = (JConfig if mod is jcp else TConfig)(**dict(
        CFGS["classic"], budget_cn=10))
    with pytest.raises(ValueError, match="must divide"):
        mod.check_cp_budgets(cfg, 4)
    mod.check_cp_budgets(dataclasses.replace(cfg, budget_cn=12), 4)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("table", ["classic", "combined"])
def test_pos_encodings_sliced_matches_jax(jds, spec, table, g):
    """Each rank's slice of the PPR encodings (per class block on the
    classic table, each slot's encoder on the combined one) and of the
    context table, against JAX's."""
    cfg = CFGS[table]
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    src, tgt = (jnp.asarray(spec[k]).astype(jnp.int32) for k in ("src", "tgt"))
    jctx = jextract(jds.graph.adj_rows, jds.graph.ppr_rows, src, tgt,
                    jcfg.context)
    tctx = ContextTables(**{f.name: torch.as_tensor(np.asarray(
        getattr(jctx, f.name))) for f in dataclasses.fields(ContextTables)})
    jparams = jax.tree.map(jnp.asarray, spec["params"])
    tparams = from_jax_params(spec["params"], device="cpu")
    for k in range(g):
        want = jcp._pos_encodings_sliced(jparams, jcfg, jctx, g, k)
        got = tcp._pos_encodings_sliced(tparams, tcfg, tctx, g, k)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **PE_TOL)
        np.testing.assert_array_equal(
            tcp._slice_blocks(tctx.ids, tcfg, g, k).numpy(),
            np.asarray(jcp._slice_blocks(jctx.ids, jcfg, g, k)))
