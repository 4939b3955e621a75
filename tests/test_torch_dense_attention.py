"""The port's dense attention route against lpformer_tpu's
``use_pallas_attention=False`` route, on the same parameters (the
port's init, copied into the JAX tree) and the same synthetic graph: propagate, the
forward h, the scores, the loss and every gradient leaf, and the
attention weights under ``return_weights``; then the port's dense route
against its own fused op, and the route rule itself.

Cases: both context tables (the combined one of budget 32, the classic
16 | 32 | 32), each at 1, 2 and 4 heads and in each of the mask modes
"all", "1-hop" and "cn" (one case a head count, the modes rotated over
them), two attention layers with one head, remat on at 2 heads, and bf16
at 2 heads. Dropouts are off and the negatives are injected, as in
tests/test_torch_train.py.

Tolerances, float32: rtol 5e-4 / atol 5e-5 on every output and gradient
leaf, the loss rtol 1e-5 (tests/test_torch_model.py, test_torch_train.py;
summation order only). bf16: atol 5e-3 on h and the gradients, 1e-3 on
the scores (tests/test_torch_model.py: a last-bit difference in an f32
value just before a bf16 rounding flips it, 2^-8 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.ops import masking as jmask
from lpformer_tpu.ops.context import extract_context as jextract
from lpformer_tpu.train import step as jstep
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops.context import extract_context as textract
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep

KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
MODES = {"all": (1e-3, 1e-3), "1-hop": (1e-3, 1), "cn": (1, 1)}
TABLES = {"combined": dict(budget_combined=32),
          "classic": dict(budget_combined=None, budget_cn=16,
                          budget_onehop=32, budget_non1hop=32)}
F32 = dict(rtol=5e-4, atol=5e-5)
BF16 = dict(rtol=0, atol=5e-3)
B = 48
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


def _configs(table, mode="all", **kw):
    t1, tn = MODES[mode]
    common = dict(dim=16, gnn_layers=1, thresh_cn=0.0, thresh_1hop=t1,
                  thresh_non1hop=tn, use_pallas_attention=False, **NO_DROP,
                  **TABLES[table], **kw)
    return JConfig(**common), TConfig(**common)


def _params(tcfg):
    """The port's init and its copy as the JAX package's tree (the same
    structure: nested dicts and lists); the JAX init's eager random ops
    would cost seconds a case."""
    tp = tlt.init_lpformer(torch.Generator().manual_seed(3), tcfg, 12,
                           device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    for x in toptim.tree_leaves(tp):
        x.requires_grad_(True)
    return jp, tp


def _batch(ds):
    rng = np.random.default_rng(10)
    pos = ds.train_pos[rng.choice(len(ds.train_pos), B, replace=False)]
    w = np.ones(B, np.float32)
    w[-5:] = 0.0
    return pos[:, 0], pos[:, 1], w, rng.integers(0, KW["num_nodes"], (2, B))


def _eval_links(jd):
    return np.concatenate([jd.valid_pos[:12], jd.valid_neg[:4]])


def _jax_run(jd, jcfg, jp, batch):
    """(X, h, scores) of the eval links, eager (its ops' compiles are
    shared across the cases), and (loss, grads) of one step, compiled."""
    links = _eval_links(jd)
    js, jt = jnp.asarray(links[:, 0]), jnp.asarray(links[:, 1])
    jx = jlt.propagate(jp, jcfg, jd.graph)
    jh = jlt.forward(jp, jcfg, jd.graph, js, jt, train=False, X_node=jx)
    jsc = jlt.score_links(jp, jcfg, jh)
    src, tgt, w, neg = (jnp.asarray(x) for x in batch)
    mr = jmask.batch_mask_ranks(jd.graph.adj_rows, src, tgt,
                                jd.mask_mult_device, weight=w)
    args = (jp, jd.graph, src, tgt, neg[0], neg[1], w, mr)
    # LLVM's optimisation level 0: a third less compile time per case,
    # the same HLO (its results agree to rounding)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, g, *a: jstep.loss_fn(p, jcfg, g, *a, None,
                                       jax.random.PRNGKey(0), False))).lower(
        *args).compile(compiler_options=O0)(*args)
    return (np.asarray(jx), np.asarray(jh), np.asarray(jsc), float(loss),
            jax.tree_util.tree_leaves_with_path(grads))


def _torch_run(td, tcfg, tp, batch, links):
    ts, tt = (torch.as_tensor(links[:, i]) for i in (0, 1))
    with torch.no_grad():
        tx = tlt.propagate(tp, tcfg, td.graph)
        th = tlt.forward(tp, tcfg, td.graph, ts, tt, X_node=tx)
        tsc = tlt.score_links(tp, tcfg, th)
    src, tgt, w, neg = (torch.as_tensor(x) for x in batch)
    mr = tmask.batch_mask_ranks(td.graph.adj_rows, src, tgt,
                                td.mask_mult_device, weight=w)
    loss = tstep.loss_fn(tp, tcfg, td.graph, src, tgt, neg[0], neg[1], w, mr,
                         None)
    leaves = toptim.tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return tx.numpy(), th.numpy(), tsc.numpy(), float(loss.detach()), grads


def _check(jd, td, jcfg, tcfg, tol=F32, score_atol=None):
    jp, tp = _params(tcfg)
    batch = _batch(jd)
    jx, jh, js, jl, jg = _jax_run(jd, jcfg, jp, batch)
    tx, th, ts, tl, tg = _torch_run(td, tcfg, tp, batch, _eval_links(jd))
    np.testing.assert_allclose(tx, jx, **tol)
    np.testing.assert_allclose(th, jh, **tol)
    np.testing.assert_allclose(
        ts, js, **(tol if score_atol is None else dict(rtol=0,
                                                       atol=score_atol)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5 if tol is F32 else 1e-3)
    assert len(jg) == len(tg)
    for (path, want), got in zip(jg, tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)
    return tp


CASES = [("combined", "all", 1), ("combined", "1-hop", 2),
         ("combined", "cn", 4), ("classic", "all", 2), ("classic", "1-hop", 4),
         ("classic", "cn", 1)]


@pytest.mark.parametrize("table,mode,heads", CASES)
def test_dense_route_matches_jax_f32(both, table, mode, heads):
    jd, td = both
    jcfg, tcfg = _configs(table, mode, num_heads=heads)
    tp = _check(jd, td, jcfg, tcfg)
    assert tp["att_layers"][0]["att"].shape == (heads, 16)
    assert tp["pairwise_lin"]["layers"][0]["w"].shape[0] == (
        16 * heads + tcfg.count_dim)


@pytest.mark.parametrize("table,variant", [
    ("combined", dict(trans_layers=2)),
    ("classic", dict(num_heads=2, remat_pairwise=True))])
def test_dense_route_variants_match_jax_f32(both, table, variant):
    """Two attention layers (one head: the JAX package refuses more), and
    the pairwise block rematerialised in the backward on both sides."""
    jd, td = both
    _check(jd, td, *_configs(table, **variant))


def test_dense_route_matches_jax_bf16(both):
    """bf16 on the combined table, whose PE blocks add in bf16."""
    jd, td = both
    _check(jd, td, *_configs("combined", num_heads=2,
                             matmul_dtype="bfloat16"),
           tol=BF16, score_atol=1e-3)


@pytest.mark.parametrize("table,heads", [("combined", 2), ("classic", 4),
                                         ("combined", 1)])
def test_return_weights_alpha_matches_jax(both, table, heads):
    """alpha [B, C, H] under return_weights (which takes the dense route
    whatever the flag says): equal to JAX's, exactly 0 on invalid slots,
    summing to 1 over each link's valid ones; the pairwise output too."""
    jd, td = both
    jcfg, tcfg = _configs(table, num_heads=heads)
    tcfg = dataclasses.replace(tcfg, use_pallas_attention=None)
    jp, tp = _params(tcfg)
    links = _eval_links(jd)
    jx = jlt.propagate(jp, jcfg, jd.graph)
    js, jt = jnp.asarray(links[:, 0]), jnp.asarray(links[:, 1])
    jctx = jextract(jd.graph.adj_rows, jd.graph.ppr_rows, js, jt,
                    jcfg.context)
    jpw, jalpha = jlt.calc_pairwise(jp, jcfg, jx, js, jt, jctx,
                                    return_weights=True)
    ts, tt = (torch.as_tensor(links[:, i]) for i in (0, 1))
    with torch.no_grad():
        tx = tlt.propagate(tp, tcfg, td.graph)
        tctx = textract(td.graph.adj_rows, td.graph.ppr_rows, ts, tt,
                        tcfg.context)
        tpw, talpha = tlt.calc_pairwise(tp, tcfg, tx, ts, tt, tctx,
                                        return_weights=True)
        _, none = tlt.calc_pairwise(tp, tcfg, tx, ts, tt, tctx)
    assert none is None
    assert talpha.shape == (len(links), tctx.ids.shape[1], heads)
    np.testing.assert_array_equal(tctx.valid.numpy(), np.asarray(jctx.valid))
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), **F32)
    np.testing.assert_allclose(tpw.numpy(), np.asarray(jpw), **F32)
    valid = tctx.valid.numpy()
    a = talpha.numpy()
    assert (a[~valid] == 0).all()
    sums = a.sum(1)
    has = valid.any(1)
    np.testing.assert_allclose(sums[has], 1.0, atol=1e-5)
    assert (sums[~has] == 0).all()


@pytest.mark.parametrize("table", list(TABLES))
def test_dense_route_matches_fused_route_f32(both, table):
    """One head in f32: the dense route and the fused op (its plain
    version, on the CPU) compute the same function."""
    jd, td = both
    _, tcfg = _configs(table)
    _, tp = _params(tcfg)
    batch = _batch(jd)
    links = _eval_links(jd)
    dense = _torch_run(td, tcfg, tp, batch, links)
    fused = _torch_run(td, dataclasses.replace(tcfg,
                                               use_pallas_attention=None),
                       tp, batch, links)
    for a, b in zip(dense[:3], fused[:3]):
        np.testing.assert_allclose(a, b, **F32)
    np.testing.assert_allclose(dense[3], fused[3], rtol=1e-5)
    for a, b in zip(dense[4], fused[4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


@pytest.mark.parametrize("flag,heads,weights,fused", [
    (None, 1, False, True), (True, 1, False, True), (False, 1, False, False),
    (None, 2, False, False), (True, 2, False, False),
    (None, 1, True, False), (True, 1, True, False)])
def test_route_rule(both, monkeypatch, flag, heads, weights, fused):
    """The fused op runs exactly when use_pallas_attention is not False,
    num_heads == 1 and no weights are asked for; else the dense route."""
    _, td = both
    _, tcfg = _configs("combined", num_heads=heads)
    tcfg = dataclasses.replace(tcfg, use_pallas_attention=flag)
    _, tp = _params(tcfg)
    calls = {"fused": 0, "dense": 0}
    real_f, real_d = tlt.fused_pe_link_attention_mixed, tlt._att_layer_apply

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tlt, "fused_pe_link_attention_mixed",
                        count("fused", real_f))
    monkeypatch.setattr(tlt, "_att_layer_apply", count("dense", real_d))
    links = torch.as_tensor(td.valid_pos[:8])
    with torch.no_grad():
        x = tlt.propagate(tp, tcfg, td.graph)
        ctx = textract(td.graph.adj_rows, td.graph.ppr_rows, links[:, 0],
                       links[:, 1], tcfg.context)
        tlt.calc_pairwise(tp, tcfg, x, links[:, 0], links[:, 1], ctx,
                          return_weights=weights)
    assert calls == ({"fused": 1, "dense": 0} if fused
                     else {"fused": 0, "dense": 1})
