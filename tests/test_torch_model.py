"""The port's model against lpformer_tpu's, on the same parameters.

Parameters come from the JAX package's init_lpformer and cross with
``from_jax_params``; propagate, forward(train=False) and score_links then
run in both packages at dim 16 with 2 GNN layers, in the three mask modes,
on both context layouts: a combined budget, and the classic per-class
blocks. The JAX side runs its dense XLA path and its Pallas kernels
(interpret mode): the mixed-class kernel on the combined table, the
class-blocked kernel on the classic one. At class widths no TPU tile
divides (12 / 40 / 20) the JAX package runs its XLA path, and the port
its op as everywhere else.

Tolerance in float32: rtol 5e-4 / atol 5e-5, as the JAX package's own
dense-vs-Pallas comparison (tests/test_combined_context.py). In bf16 the
port is held to the JAX Pallas path, whose roundings it reproduces (max
error 3e-8 on h at this size); but a last-bit difference in an f32 sum
just before a bf16 rounding would flip it (2^-8 relative), so the bound
is atol 5e-3 on h and 1e-3 on the scores.
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
from lpformer_tpu.ops.segment import masked_softmax as jax_masked_softmax
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops.segment import masked_softmax
from lpformer_tpu_torch.utils.params import from_jax_params

KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)
MODES = {"all": (1e-3, 1e-3), "1-hop": (1e-3, 1), "cn": (1, 1)}
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0)


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


CLASSIC = dict(budget_combined=None, budget_cn=16, budget_onehop=32,
               budget_non1hop=32)
MISALIGNED = dict(budget_combined=None, budget_cn=12, budget_onehop=40,
                  budget_non1hop=20)


def _configs(mode, **kw):
    t1, tn = MODES[mode]
    common = dict(dict(dim=16, gnn_layers=2, thresh_cn=0.0, thresh_1hop=t1,
                       thresh_non1hop=tn, budget_combined=32), **kw)
    return JConfig(**common, **NO_DROP), TConfig(**common)


def _run(jd, td, jcfg, tcfg, pallas, links=None):
    jcfg = dataclasses.replace(jcfg, use_pallas_attention=pallas)
    jp = jlt.init_lpformer(jax.random.PRNGKey(3), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    if links is None:
        links = np.concatenate([jd.valid_pos[:12], jd.valid_neg[:4]])
    js, jt = jnp.asarray(links[:, 0]), jnp.asarray(links[:, 1])
    ts, tt = torch.as_tensor(links[:, 0]), torch.as_tensor(links[:, 1])
    jx = jlt.propagate(jp, jcfg, jd.graph)
    jh = jlt.forward(jp, jcfg, jd.graph, js, jt, train=False, X_node=jx)
    jsc = jlt.score_links(jp, jcfg, jh)
    tx = tlt.propagate(tp, tcfg, td.graph)
    th = tlt.forward(tp, tcfg, td.graph, ts, tt, X_node=tx)
    tsc = tlt.score_links(tp, tcfg, th)
    return (np.asarray(jx), np.asarray(jh), np.asarray(jsc)), (
        tx.numpy(), th.numpy(), tsc.numpy())


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("mode", ["all", "1-hop", "cn"])
def test_forward_and_scores_match_f32(both, mode, pallas):
    jd, td = both
    (jx, jh, js), (tx, th, ts) = _run(jd, td, *_configs(mode), pallas)
    np.testing.assert_allclose(tx, jx, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(th, jh, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ts, js, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("mode", ["all", "1-hop", "cn"])
def test_classic_forward_and_scores_match_f32(both, mode, pallas):
    jd, td = both
    jcfg, tcfg = _configs(mode, **CLASSIC)
    if pallas:   # the JAX package takes its class-blocked Pallas kernel
        assert jlt._pe_tiles(dataclasses.replace(
            jcfg, use_pallas_attention=True))[1]
    (jx, jh, js), (tx, th, ts) = _run(jd, td, jcfg, tcfg, pallas)
    np.testing.assert_allclose(tx, jx, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(th, jh, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ts, js, rtol=5e-4, atol=5e-5)


def test_classic_misaligned_budgets_match_xla_f32(both):
    jd, td = both
    jcfg, tcfg = _configs("all", **MISALIGNED)
    assert jlt._pe_tiles(dataclasses.replace(
        jcfg, use_pallas_attention=True)) == (0, ())
    (_, jh, js), (_, th, ts) = _run(jd, td, jcfg, tcfg, False)
    np.testing.assert_allclose(th, jh, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ts, js, rtol=5e-4, atol=5e-5)


def test_classic_forward_and_scores_match_bf16(both):
    jd, td = both
    (jx, jh, js), (tx, th, ts) = _run(
        jd, td, *_configs("all", matmul_dtype="bfloat16", **CLASSIC), True)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=5e-3)
    np.testing.assert_allclose(th, jh, rtol=0, atol=5e-3)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-3)


def test_two_attention_layers_match_f32(both):
    jd, td = both
    (_, jh, js), (_, th, ts) = _run(
        jd, td, *_configs("all", trans_layers=2), True)
    np.testing.assert_allclose(th, jh, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ts, js, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("wide", [dict(dim=256),
                                  dict(dim=128, trans_layers=2)])
def test_wide_layers_match_f32(both, wide):
    """Past the main path's 128 columns: dim 256 (O = dh = 256, the
    ddi-like width), and two attention layers at dim 128, whose first has
    O = 256 over dh = 128; the JAX side through its Pallas kernel."""
    jd, td = both
    (jx, jh, js), (tx, th, ts) = _run(jd, td, *_configs("all", **wide),
                                      True)
    np.testing.assert_allclose(tx, jx, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(th, jh, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ts, js, rtol=5e-4, atol=5e-5)


TABLES = {"combined": {}, "classic": CLASSIC}
# GCN and link options no other case sets, at dim 16 with 3 GNN layers
OPTIONS = {"residual": dict(residual=True),
           "no_ln_no_relu": dict(layer_norm=False, relu=False)}


def _degenerate_links(jd):
    """(u, u) pairs, (0, 0) and a few real links around them."""
    u = jd.valid_pos[:4, 0]
    return np.concatenate([np.stack([u, u], 1), [[0, 0]], jd.valid_pos[:4],
                           [[0, 0]]])


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("option", list(OPTIONS) + ["degenerate_pairs"])
def test_options_and_degenerate_pairs_match_f32(both, table, option):
    """residual=True, the GCN without LayerNorm and ReLU, and (u, u) /
    (0, 0) links, on both tables, against the JAX Pallas path."""
    jd, td = both
    kw = dict(TABLES[table], gnn_layers=3, **OPTIONS.get(option, {}))
    links = _degenerate_links(jd) if option == "degenerate_pairs" else None
    (jx, jh, js), (tx, th, ts) = _run(jd, td, *_configs("all", **kw), True,
                                      links=links)
    np.testing.assert_allclose(tx, jx, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(th, jh, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ts, js, rtol=5e-4, atol=5e-5)
    assert np.isfinite(ts).all()


def test_forward_and_scores_match_bf16(both):
    jd, td = both
    (jx, jh, js), (tx, th, ts) = _run(
        jd, td, *_configs("all", matmul_dtype="bfloat16"), True)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=5e-3)
    np.testing.assert_allclose(th, jh, rtol=0, atol=5e-3)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-3)


def test_masked_softmax_matches():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 7)).astype(np.float32) * 10
    valid = rng.random((5, 7)) < 0.5
    valid[2] = False  # a row with no valid entry -> all zeros
    want = np.asarray(jax_masked_softmax(jnp.asarray(logits),
                                         jnp.asarray(valid), axis=1))
    got = masked_softmax(torch.as_tensor(logits), torch.as_tensor(valid), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[2].any()


def test_unported_layouts_raise(both):
    _, td = both
    src = torch.as_tensor([0, 1])
    tcfg = TConfig(dim=16, gnn_layers=2, num_heads=2, budget_combined=32)
    tp = tlt.init_lpformer(torch.Generator().manual_seed(0), tcfg, 12,
                           device="cpu")
    with pytest.raises(NotImplementedError):
        tlt.forward(tp, tcfg, td.graph, src, src)
