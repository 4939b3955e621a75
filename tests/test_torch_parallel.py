"""The port's mesh path (lpformer_tpu_torch/parallel/) against lpformer_tpu's
on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices of
tests/conftest.py; the port runs as 4 gloo ranks, one pool for the whole
module (``torch_mesh_cases.run_cases``), on meshes (1, 4), (2, 2) and
(4, 1). Inputs are tests/test_parallel.py's: 96 nodes, dim 16, the
classic table of 24 | 48 | 48 (and the combined table of 120), dropout
off, negatives injected, the JAX package's parameters through
``from_jax_params``.

Tolerances, float32: the loss rtol 2e-5 / atol 1e-6 (tests/
test_multihost.py); gradients rtol 5e-4 / atol 5e-5 (tests/
test_torch_grad_accum.py); scores rtol 2e-4 / atol 2e-5 and eval metrics
2e-3 (tests/test_parallel.py). ``partition_graph``, the row fetch and
the replicated values across ranks are held bit for bit. bfloat16 (the
sharded SpMM's bf16 gather, forward and backward): against the port's
single-device step over the same COO GCN with the batch split as the
ranks split it, as chip_smoke.py's phase 15 holds it (MESH_BF16_*).
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
from lpformer_tpu.parallel import make_mesh as jmake_mesh
from lpformer_tpu.parallel import make_sharded_loss as jsharded_loss
from lpformer_tpu.parallel import partition_graph as jpartition
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import context as tcontext
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.parallel import distributed, partition_graph
from lpformer_tpu_torch.parallel.partition import sharded_graph_specs
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.utils.params import from_jax_params

import torch_mesh_cases

KW = dict(seed=0, num_nodes=96, num_train=320, num_eval=32, feat_dim=12,
          mask_input=True)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
CLASSIC = dict(dim=16, gnn_layers=2, budget_cn=24, budget_onehop=48,
               budget_non1hop=48)
CFGS = {"classic": dict(CLASSIC, **NO_DROP),
        "combined": dict(CLASSIC, budget_combined=120, **NO_DROP),
        "bf16": dict(CLASSIC, matmul_dtype="bfloat16", **NO_DROP),
        "encoder_dropout": dict(CLASSIC, **dict(NO_DROP, gnn_drop=0.3,
                                                feat_drop=0.2)),
        "dropout": CLASSIC}
MESHES = [(1, 4), (2, 2), (4, 1)]
# variant -> (config, make_sharded_loss keywords)
VARIANTS = {"plain": ("classic", {}),
            "mask_input": ("classic", {"mask_input": True}),
            "combined": ("combined", {})}
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
SCORE_TOL = dict(rtol=2e-4, atol=2e-5)
# bf16, per leaf ||mesh - single|| / ||single|| (chip_smoke.py's
# MESH_BF16_* and STEP_LOSS_TOL, STEP_GRAD_TOL): the loss 1e-3, the median
# leaf 1e-2, every leaf 0.25, the GCN's leaves 2e-2
BF16_LOSS_TOL, BF16_MEDIAN_TOL, BF16_LEAF_TOL, BF16_GCN_TOL = (
    1e-3, 1e-2, 0.25, 2e-2)
B = 32
RANKS = 4


def _mesh_name(d, g):
    return f"{d}x{g}"


CASES = (
    [dict(kind="fetch", name=f"fetch/{_mesh_name(*m)}", mesh=m)
     for m in MESHES]
    + [dict(kind="loss", name=f"loss/{v}/{_mesh_name(*m)}", mesh=m,
            cfg=VARIANTS[v][0], kw=VARIANTS[v][1])
       for v in VARIANTS for m in MESHES]
    + [dict(kind="loss", name=f"loss/bf16/{_mesh_name(*m)}", mesh=m,
            cfg="bf16") for m in MESHES]
    + [dict(kind="encoder_dropout", name="encoder_dropout", mesh=(2, 2),
            cfg="encoder_dropout"),
       dict(kind="descend", name="descend", mesh=(2, 2), cfg="dropout"),
       dict(kind="multi_step", name="multi_step", mesh=(2, 2),
            cfg="classic"),
       dict(kind="eval", name="eval", mesh=(2, 2), cfg="classic"),
       dict(kind="collectives", name="collectives", mesh=(2, 2)),
       dict(kind="backend_route", name="backend_route", mesh=(2, 2)),
       dict(kind="train_loop", name="train_loop", cfg="dropout",
            args=dict(epochs=2, eval_steps=1, batch_size=32,
                      test_batch_size=64, metric="MRR", verbose=False,
                      mesh="2,2", lr=5e-3))])


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


@pytest.fixture(scope="module")
def both_sides(jds, spec):
    """(every case on 4 gloo ranks: [rank] -> {case name: result}, JAX's
    sharded loss and gradients of every (variant, mesh)). The pool runs
    while the JAX programs compile, side by side in threads (XLA compiles
    without the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    keys = [(v, d, g) for v in VARIANTS for d, g in MESHES]
    with ThreadPoolExecutor(4) as ex:
        ranks = ex.submit(distributed.spawn_local, torch_mesh_cases.run_cases,
                          RANKS, (spec,), device="cpu", timeout_s=600,
                          threads=1)
        futs = [ex.submit(_jax_sharded, jds, spec, *k) for k in keys]
        return ranks.result(), dict(zip(keys, (f.result() for f in futs)))


@pytest.fixture(scope="module")
def pool(both_sides):
    return both_sides[0]


@pytest.fixture(scope="module")
def jax_ref(both_sides):
    return both_sides[1]


def _port_single(tds, spec, variant):
    """The port's single-device loss and gradients of the batch."""
    cfg_name, kw = VARIANTS[variant]
    cfg = TConfig(**CFGS[cfg_name])
    params = from_jax_params(spec["params"], device="cpu")
    leaves = toptim.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    src, tgt, neg, w = (torch.as_tensor(spec[k])
                        for k in ("src", "tgt", "neg", "w"))
    mr = tmask.batch_mask_ranks(tds.graph.adj_rows, src, tgt,
                                tds.mask_mult_device, weight=w)
    mi = kw.get("mask_input", False)
    prop_w = (tmask.mask_edge_weights(mr, tds.graph.edge_rank,
                                      (tds.graph.edge_w > 0).float())
              if mi else None)
    loss = tstep.loss_fn(params, cfg, tds.graph, src, tgt, neg[0], neg[1],
                         w, mr, None, prop_w, mi)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _port_single_bf16(tds, spec, n):
    """The port's single-device bf16 loss and gradients over the COO GCN
    (the mesh's), the batch split into ``n`` parts as ``n`` link ranks
    split it (the whole batch's denominators, the parts' gradients
    summed); with the leaves' paths."""
    cfg = TConfig(**CFGS["bf16"])
    graph = dataclasses.replace(tds.graph, ell=None)
    params = from_jax_params(spec["params"], device="cpu")
    leaves = toptim.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    src, tgt, neg, w = (torch.as_tensor(spec[k])
                        for k in ("src", "tgt", "neg", "w"))
    mr = tmask.batch_mask_ranks(tds.graph.adj_rows, src, tgt,
                                tds.mask_mult_device, weight=w)
    per, loss, grads = B // n, 0.0, None
    for i in range(n):
        sl = slice(i * per, (i + 1) * per)
        part = tstep.loss_fn(params, cfg, graph, src[sl], tgt[sl],
                             neg[0, sl], neg[1, sl], w[sl], mr, None, None,
                             False, pos_denom=w.sum(), neg_denom=w.sum())
        g = torch.autograd.grad(part, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss = loss + float(part.detach())
    paths = ["/".join(map(str, p))
             for p, _ in toptim.tree_leaves_with_path(params)]
    return loss, [g.numpy() for g in grads], paths


def _jax_sharded(jds, spec, variant, d, g):
    cfg_name, kw = VARIANTS[variant]
    cfg = JConfig(**CFGS[cfg_name])
    mesh = jmake_mesh(data=d, graph=g, devices=jax.devices()[:d * g])
    sg = jpartition(jds.graph, g=g, d=d,
                    mask_input=kw.get("mask_input", False))
    loss = jsharded_loss(cfg, mesh, jds.num_nodes, sg.rows_per_shard,
                         sg.ctx_rows_per_shard, train=True, **kw)
    params = jax.tree.map(jnp.asarray, spec["params"])
    src, tgt, w = (jnp.asarray(spec[k]).astype(
        jnp.float32 if k == "w" else jnp.int32) for k in ("src", "tgt", "w"))
    neg = jnp.asarray(spec["neg"]).astype(jnp.int32)
    val, grads = jax.jit(jax.value_and_grad(lambda p: loss(
        p, sg, jds.mask_mult_device, src, tgt, w, neg[0], neg[1], w,
        jax.random.PRNGKey(7))))(params)
    return float(val), [np.asarray(x) for x in jax.tree_util.tree_leaves(
        grads)]


@pytest.mark.parametrize("mask_input", [False, True])
@pytest.mark.parametrize("d,g", MESHES)
def test_partition_graph_matches_jax(jds, tds, d, g, mask_input):
    """Every array and size of partition_graph, bit for bit."""
    want = jpartition(jds.graph, g=g, d=d, mask_input=mask_input)
    got = partition_graph(tds.graph, g=g, d=d, mask_input=mask_input)
    for name in sharded_graph_specs():
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    for name in ("num_nodes", "num_nodes_padded", "rows_per_shard",
                 "ctx_rows_per_shard", "adj_cap", "ppr_cap", "g", "d"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _mesh_name(*m))
def test_row_fetch_matches_local_gather(pool, tds, mesh):
    """Each rank's fetched rows are the whole tables' rows, bit for bit,
    bools as bools."""
    for rank, out in enumerate(pool):
        got = out[f"fetch/{_mesh_name(*mesh)}"]
        want = tcontext.gather_link_rows(tds.graph.adj_rows,
                                         tds.graph.ppr_rows,
                                         torch.as_tensor(got["ids"]))
        for f, a in got["rows"].items():
            b = getattr(want, f).numpy()
            assert a.dtype == b.dtype, (rank, f)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} {f}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _mesh_name(*m))
def test_context_state_is_row_sharded(pool, mesh):
    """Each rank holds ctx_rows_per_shard rows of every context table."""
    for out in pool:
        got = out[f"fetch/{_mesh_name(*mesh)}"]
        assert got["ctx_rows_per"] * RANKS >= KW["num_nodes"]
        assert got["local_rows"] == [got["ctx_rows_per"]] * 6


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _mesh_name(*m))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_loss_matches(pool, jax_ref, tds, spec, variant, mesh):
    """The sharded loss against JAX's make_sharded_loss at the same mesh
    and against the port's single-device loss; every rank the same."""
    got = [out[f"loss/{variant}/{_mesh_name(*mesh)}"] for out in pool]
    assert all(r["loss"] == got[0]["loss"] for r in got)
    want, _ = jax_ref[(variant, *mesh)]
    single, _ = _port_single(tds, spec, variant)
    np.testing.assert_allclose(got[0]["loss"], want, **LOSS_TOL)
    np.testing.assert_allclose(got[0]["loss"], single, **LOSS_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _mesh_name(*m))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_grads_match(pool, jax_ref, tds, spec, variant, mesh):
    """Every gradient leaf, summed over the mesh, against JAX's sharded
    gradient and the port's single-device one; bit-equal on every rank."""
    got = [out[f"loss/{variant}/{_mesh_name(*mesh)}"]["grads"]
           for out in pool]
    for r in got[1:]:
        for a, b in zip(r, got[0]):
            np.testing.assert_array_equal(a, b)
    _, want = jax_ref[(variant, *mesh)]
    _, single = _port_single(tds, spec, variant)
    assert len(got[0]) == len(want) == len(single)
    for a, b, c in zip(got[0], want, single):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
        np.testing.assert_allclose(a, c, **GRAD_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _mesh_name(*m))
def test_sharded_bf16_step_holds(pool, tds, spec, mesh):
    """bf16: the sharded loss and gradients against the single-device
    step over the same COO GCN, the batch split as the ranks split it:
    the loss, the median leaf, every leaf and the GCN's leaves (the
    sharded SpMM's bf16 gather feeds them); bit-equal on every rank."""
    got = [out[f"loss/bf16/{_mesh_name(*mesh)}"] for out in pool]
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"]
        for a, b in zip(r["grads"], got[0]["grads"]):
            np.testing.assert_array_equal(a, b)
    loss, want, paths = _port_single_bf16(tds, spec, mesh[0] * mesh[1])
    assert abs(got[0]["loss"] - loss) <= BF16_LOSS_TOL
    rel = [float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
           for a, b in zip(got[0]["grads"], want)]
    gcn = [e for e, p in zip(rel, paths)
           if p.startswith(("node_encoder", "gnn_norm"))]
    assert len(rel) == len(paths) and gcn
    assert np.median(rel) <= BF16_MEDIAN_TOL, np.median(rel)
    assert max(rel) <= BF16_LEAF_TOL, (max(rel), paths[rel.index(max(rel))])
    assert max(gcn) <= BF16_GCN_TOL, max(gcn)
    assert all(np.isfinite(a).all() for a in got[0]["grads"])


def test_mask_input_variant_is_live(tds, spec):
    """The masked propagation changes the loss, so the mask_input cases
    above test something."""
    assert abs(_port_single(tds, spec, "mask_input")[0]
               - _port_single(tds, spec, "plain")[0]) > 1e-6


def test_encoder_dropout_invariant_along_data(pool):
    """With feature and GCN dropout on, every rank of the (2, 2) mesh
    propagates the same X_full, bit for bit: the encoder's masks depend on
    the graph index only, so the partial sums met over 'data' agree."""
    xs = [out["encoder_dropout"]["X"] for out in pool]
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])
    assert np.isfinite(xs[0]).all()


def test_sharded_train_step_descends(pool):
    """Four steps with the default dropouts: the loss falls, and the
    parameters stay bit-identical on every rank."""
    got = [out["descend"] for out in pool]
    assert got[0]["losses"][-1] < got[0]["losses"][0], got[0]["losses"]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        for a, b in zip(r["params"], got[0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_steps_per_call_matches_sequential(pool):
    """steps_per_call 3 with a dead third step equals two single steps:
    the same losses and parameters, the dead step reads 0 and leaves the
    step count."""
    got = pool[0]["multi_step"]
    np.testing.assert_array_equal(got["multi"][:2], got["seq"])
    assert got["multi"][2] == 0.0
    assert got["steps"] == (2, 2)
    for a, b in zip(*got["params"]):
        np.testing.assert_array_equal(a, b)


def test_sharded_eval_matches_single_device(pool):
    """The sharded scorer and score_group against the single-device
    scores, and test_standard over the mesh against the single-device
    sweep; every rank holds every score."""
    for out in pool:
        got = out["eval"]
        np.testing.assert_allclose(got["got"], got["want"], **SCORE_TOL)
        np.testing.assert_allclose(got["group"], got["want_group"],
                                   **SCORE_TOL)
        for k, want in got["want_metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], want, atol=2e-3)
    np.testing.assert_array_equal(pool[1]["eval"]["got"],
                                  pool[0]["eval"]["got"])
    # the one-call scorer (propagates each call) gives the same bits
    np.testing.assert_array_equal(pool[0]["eval"]["one_call"],
                                  pool[0]["eval"]["got"])


def test_collectives_and_their_gradients(pool):
    """all_gather tiles in rank order and its backward sums each block's
    cotangents over the ranks; psum's backward sums the cotangents; pmax
    takes the largest."""
    n = RANKS
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(n)]
    for r, out in enumerate(pool):
        got = out["collectives"]
        np.testing.assert_array_equal(got["gather"], np.concatenate(xs))
        # d/dx_r of sum_s sum(w_s * gather(x)) = sum_s w_s = 1 + ... + n
        np.testing.assert_array_equal(got["g_gather"],
                                      np.full((2, 3), n * (n + 1) / 2))
        np.testing.assert_array_equal(got["g_psum"],
                                      np.full((2, 3), n * (n + 1) / 2))
        np.testing.assert_array_equal(
            got["pmax"], np.max([x * (1 if s % 2 else -1)
                                 for s, x in enumerate(xs)], axis=0))


def test_backend_reduction_route(pool):
    """The route NCCL groups take (the backend's all-reduce and
    reduce-scatter), run on gloo: the collectives' values and gradients
    as above, a reduce-scatter's blocks, and the sharded loss and
    gradients within the f32 tolerances of the rank-ordered sums (gloo's
    all-reduce rounds otherwise)."""
    n = RANKS
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(n)]
    total = sum(np.arange(8 * n, dtype=np.float32).reshape(-1, 2) * (r + 1)
                for r in range(n))
    for r, out in enumerate(pool):
        got = out["backend_route"]
        np.testing.assert_array_equal(got["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(got["g_gather"],
                                      np.full((2, 3), n * (n + 1) / 2))
        np.testing.assert_array_equal(got["g_psum"],
                                      np.full((2, 3), n * (n + 1) / 2))
        np.testing.assert_array_equal(
            got["pmax"], np.max([x * (1 if s % 2 else -1)
                                 for s, x in enumerate(xs)], axis=0))
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      np.split(total, n)[r])
        want = out["loss/plain/2x2"]
        np.testing.assert_allclose(got["loss"]["loss"], want["loss"],
                                   **LOSS_TOL)
        for a, b in zip(got["loss"]["grads"], want["grads"]):
            np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_trainer_mesh_path_end_to_end(pool):
    """train_loop with mesh '2,2' runs two epochs with the sharded eval:
    finite losses and metrics, the same on every rank."""
    got = [out["train_loop"] for out in pool]
    assert got[0]["best"] > 0.0
    assert all(np.isfinite(x).all() for x in got[0]["losses"])
    for r in got[1:]:
        assert r["best"] == got[0]["best"]
        assert r["results"] == got[0]["results"]
