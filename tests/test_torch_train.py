"""The port's training path against the JAX package's, on the same
parameters (``from_jax_params``) and the same synthetic graph: the
symmetric SpMM backward, the loss and every gradient leaf (on the combined
and on the classic context table), the fused optimizer, two whole steps,
dropout, and train_loop end to end.

Parity runs with every dropout off and the negatives injected through
``loss_fn``'s neg_src / neg_tgt (JAX's PRNG is not torch's). The JAX side
runs its dense XLA attention and its Pallas kernel pair of the table's
layout in interpret mode (``use_pallas_attention`` False / True).

Tolerances, float32: the loss rtol 1e-5; gradients rtol 5e-4 / atol 5e-5,
four times tighter than the JAX package's own dense-vs-Pallas grad bound
(rtol 2e-3 / atol 2e-4, tests/test_combined_context.py:154-155), which
this holds (worst element 1.0e-4 relative at this size: summation order
only); the optimizer on identical gradients rtol 1e-5 / atol 1e-7
(elementwise f32 on both sides; the JAX package holds its fused optimizer
to its optax chain at 2e-5 / 2e-7).
Parameters after whole steps: Adam's first steps move each element by
about lr * sign(g), so an element whose gradient is at rounding-noise
level may move either way on either side; they are held to atol
2 * lr * 1e-2 except on elements whose |g| is below 1e-6 of the leaf's
largest.
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
from lpformer_tpu.ops import spmm as jspmm
from lpformer_tpu.train import optim as joptim
from lpformer_tpu.train import step as jstep
from lpformer_tpu.train import trainer as jtrainer
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.nn import core as tnn
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops import spmm as tspmm
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.train import trainer as ttrainer
from lpformer_tpu_torch.utils.params import (
    from_jax_opt_state, from_jax_params,
)

KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
COMMON = dict(dim=16, gnn_layers=2, thresh_cn=0.0, thresh_1hop=1e-3,
              thresh_non1hop=1e-3, budget_combined=32, **NO_DROP)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
B = 48


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


def _jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _tleaves(tree):
    return [x for _, x in toptim.tree_leaves_with_path(tree)]


def _batch(ds, step):
    """Positives with zero-weight padding at the end and injected
    negatives, as numpy."""
    rng = np.random.default_rng(10 + step)
    pos = ds.train_pos[rng.choice(len(ds.train_pos), B, replace=False)]
    w = np.ones(B, np.float32)
    w[-5:] = 0.0
    neg = rng.integers(0, KW["num_nodes"], (2, B))
    return pos[:, 0], pos[:, 1], w, neg


def _params(pallas, common=COMMON):
    jcfg = JConfig(**common, use_pallas_attention=pallas)
    jp = jlt.init_lpformer(jax.random.PRNGKey(3), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for x in _tleaves(tp):
        x.requires_grad_(True)
    return jcfg, jp, tp


def _jax_loss_grads(jd, jcfg, jp, batch):
    src, tgt, w, neg = (jnp.asarray(x) for x in batch)
    mr = jmask.batch_mask_ranks(jd.graph.adj_rows, src, tgt,
                                jd.mask_mult_device, weight=w)
    return jax.value_and_grad(jstep.loss_fn)(
        jp, jcfg, jd.graph, src, tgt, neg[0], neg[1], w, mr, None,
        jax.random.PRNGKey(0), False)


def _torch_loss_grads(td, tcfg, tp, batch):
    src, tgt, w, neg = (torch.as_tensor(x) for x in batch)
    mr = tmask.batch_mask_ranks(td.graph.adj_rows, src, tgt,
                                td.mask_mult_device, weight=w)
    loss = tstep.loss_fn(tp, tcfg, td.graph, src, tgt, neg[0], neg[1], w,
                         mr, None)
    leaves = _tleaves(tp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for x, g in zip(leaves, grads)]


@pytest.mark.parametrize("bf16", [False, True])
def test_spmm_bell_backward_matches_jax_vjp(both, bf16):
    jd, td = both
    rng = np.random.default_rng(0)
    x = rng.standard_normal((KW["num_nodes"], 16)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    gd = jnp.bfloat16 if bf16 else None
    _, vjp = jax.vjp(lambda v: jspmm.spmm_bell(
        jd.graph.ell, None, v, diag=jd.graph.w_diag, gather_dtype=gd),
        jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    tx = torch.as_tensor(x).requires_grad_(True)
    out = tspmm.spmm_bell(td.graph.ell, None, tx, diag=td.graph.w_diag,
                          gather_dtype=torch.bfloat16 if bf16 else None)
    out.backward(torch.as_tensor(ct))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pallas", [False, True])
def test_loss_and_grads_match_jax(both, pallas):
    jd, td = both
    jcfg, jp, tp = _params(pallas)
    batch = _batch(td, 0)
    jl, jg = _jax_loss_grads(jd, jcfg, jp, batch)
    tl, tg = _torch_loss_grads(td, TConfig(**COMMON), tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = _jleaves(jg)
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                   **GRAD_TOL)


@pytest.mark.parametrize("pallas", [False, True])
def test_classic_loss_and_grads_match_jax(both, pallas):
    """The classic per-class context table (the JAX package's default
    layout): one step's loss and every grad leaf, against the JAX XLA path
    and its class-blocked Pallas kernel pair."""
    jd, td = both
    common = dict(COMMON, budget_combined=None, budget_cn=16,
                  budget_onehop=32, budget_non1hop=32)
    jcfg, jp, tp = _params(pallas, common)
    batch = _batch(td, 0)
    jl, jg = _jax_loss_grads(jd, jcfg, jp, batch)
    tl, tg = _torch_loss_grads(td, TConfig(**common), tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = _jleaves(jg)
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                   **GRAD_TOL)


@pytest.mark.parametrize("wide", [dict(dim=256),
                                  dict(dim=128, trans_layers=2)])
def test_wide_loss_and_grads_match_jax(both, wide):
    """One step past the main path's 128 columns (dim 256; two attention
    layers at dim 128, the first with O = 256), against the JAX package's
    Pallas kernel pair."""
    jd, td = both
    common = dict(COMMON, **wide)
    jcfg, jp, tp = _params(True, common)
    batch = _batch(td, 0)
    jl, jg = _jax_loss_grads(jd, jcfg, jp, batch)
    tl, tg = _torch_loss_grads(td, TConfig(**common), tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = _jleaves(jg)
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                   **GRAD_TOL)


TABLES = {"combined": {},
          "classic": dict(budget_combined=None, budget_cn=16,
                          budget_onehop=32, budget_non1hop=32)}
OPTIONS = {"residual": dict(residual=True),
           "no_ln_no_relu": dict(layer_norm=False, relu=False)}


def _degenerate_batch(ds):
    """``_batch`` with (u, u) and (0, 0) positives and negatives."""
    src, tgt, w, neg = _batch(ds, 0)
    src, tgt, neg = src.copy(), tgt.copy(), neg.copy()
    tgt[:6] = src[:6]
    src[6:8] = tgt[6:8] = 0
    neg[1, :4] = neg[0, :4]
    neg[:, 4:6] = 0
    return src, tgt, w, neg


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("option", list(OPTIONS) + ["degenerate_pairs"])
def test_options_and_degenerate_pairs_loss_and_grads_match_jax(both, table,
                                                               option):
    """dim 16, 3 GNN layers: residual=True, the GCN without LayerNorm and
    ReLU, and (u, u) / (0, 0) links; one step's loss and every grad leaf
    on both tables against the JAX Pallas kernel pair."""
    jd, td = both
    common = dict(COMMON, gnn_layers=3, **TABLES[table],
                  **OPTIONS.get(option, {}))
    jcfg, jp, tp = _params(True, common)
    batch = (_degenerate_batch(td) if option == "degenerate_pairs"
             else _batch(td, 0))
    jl, jg = _jax_loss_grads(jd, jcfg, jp, batch)
    tl, tg = _torch_loss_grads(td, TConfig(**common), tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = _jleaves(jg)
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                   **GRAD_TOL)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"gcn": {"w": r(8, 8), "b": r(8)},
            "att_layers": [{"w": r(8, 4)}, {"w": r(4, 4)}],
            "score": {"layers": [{"w": r(4, 1) * 3, "b": r(1)}]}}


def test_fused_optimizer_matches_jax():
    """One update from init, then a second from the JAX state carried over
    by from_jax_opt_state, on identical gradients: one far above the clip
    norm, with weight decay and an epoch decay boundary between them."""
    params = _opt_tree(0)
    grads = [jax.tree.map(lambda a: a * s, _opt_tree(1 + i))
             for i, s in enumerate((50.0, 0.3))]
    jopt = joptim.make_optimizer(1e-2, 1e-4, decay=0.9, steps_per_epoch=1,
                                 fused=True)
    topt = toptim.make_optimizer(1e-2, 1e-4, decay=0.9, steps_per_epoch=1)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = jax.tree.map(torch.as_tensor, params)
    tstate = topt.init(tparams)
    for i, g in enumerate(grads):
        if i == 1:   # continue from the JAX state, carried over
            tstate = from_jax_opt_state(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                   jparams)
        jparams = jax.tree.map(jnp.add, jparams, jupd)
        tupd, tstate = topt.update(jax.tree.map(torch.as_tensor, g), tstate,
                                   tparams)
        toptim.apply_updates(tparams, tupd)
        for (path, want), got in zip(_jleaves(jparams), _tleaves(tparams)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-7, err_msg=path)
        for k in ("m", "v", "score_mask"):
            np.testing.assert_allclose(tstate[k].numpy(),
                                       np.asarray(jstate[k]), rtol=1e-5,
                                       atol=1e-12, err_msg=k)
        assert int(tstate["count"]) == int(jstate["count"]) == i + 1


@pytest.mark.parametrize("pallas", [False, True])
def test_two_training_steps_match_jax(both, pallas):
    """Loss and grads, then the updated parameters and optimizer state,
    after one and after two steps (the second from the first's state)."""
    jd, td = both
    jcfg, jp, tp = _params(pallas)
    tcfg = TConfig(**COMMON)
    lr = 1e-3
    jopt = joptim.make_optimizer(lr, steps_per_epoch=7, fused=True)
    topt = toptim.make_optimizer(lr, steps_per_epoch=7)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(2):
        batch = _batch(td, step)
        jl, jg = _jax_loss_grads(jd, jcfg, jp, batch)
        tl, tg = _torch_loss_grads(td, tcfg, tp, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for (path, want), got in zip(_jleaves(jg), tg):
            np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                       **GRAD_TOL)
        jupd, jstate = jopt.update(jg, jstate, jp)
        jp = jax.tree.map(jnp.add, jp, jupd)
        by_path = dict(zip(
            [p for p, _ in toptim.tree_leaves_with_path(tp)], tg))
        grads = toptim.tree_map_with_path(lambda p, _: by_path[p], tp)
        tupd, tstate = topt.update(grads, tstate, tp)
        toptim.apply_updates(tp, tupd)
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        for (path, want), got, (_, g) in zip(_jleaves(jp), _tleaves(tp),
                                             _jleaves(jg)):
            settled = np.abs(g) >= 1e-6 * np.abs(g).max()
            np.testing.assert_allclose(got.detach().numpy()[settled],
                                       want[settled], rtol=0,
                                       atol=2 * lr * 1e-2, err_msg=path)
        for k in ("m", "v"):
            np.testing.assert_allclose(tstate[k].numpy(),
                                       np.asarray(jstate[k]), **GRAD_TOL)


def test_dropout_rate_scale_and_determinism():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = tnn.dropout(gen, x, 0.2, True)
    kept = y != 0
    # binomial: std of the kept fraction is ~9e-4 here
    assert abs(float(kept.float().mean()) - 0.8) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    again = tnn.dropout(torch.Generator().manual_seed(0), x, 0.2, True)
    assert torch.equal(y, again)
    other = tnn.dropout(torch.Generator().manual_seed(1), x, 0.2, True)
    assert not torch.equal(y, other)
    for same in (tnn.dropout(gen, x, 0.2, False), tnn.dropout(None, x, 0.2,
                                                              True),
                 tnn.dropout(gen, x, 0.0, True)):
        assert same is x


def test_train_mode_draws_every_dropout(both):
    """With dropouts on, train-mode scores depend on the generator's seed
    (and repeat with it); eval mode ignores the generator."""
    _, td = both
    cfg = TConfig(**dict(COMMON, dropout=0.3, gnn_drop=0.3, att_drop=0.3,
                         feat_drop=0.3, pred_drop=0.3))
    tp = tlt.init_lpformer(torch.Generator().manual_seed(0), cfg, 12,
                           device="cpu")
    src = torch.as_tensor(td.train_pos[:20, 0])
    tgt = torch.as_tensor(td.train_pos[:20, 1])

    def score(seed, train):
        gen = torch.Generator().manual_seed(seed)
        h = tlt.forward(tp, cfg, td.graph, src, tgt, gen=gen, train=train)
        return tlt.score_links(tp, cfg, h, gen=gen, train=train)

    assert torch.equal(score(1, True), score(1, True))
    assert not torch.equal(score(1, True), score(2, True))
    assert torch.equal(score(1, False), score(2, False))


def test_train_loop_runs_and_logs_like_jax(both, monkeypatch):
    """Two epochs on the tiny graph on the CPU: every loss finite, one
    logged result per epoch, and the same result keys as the JAX
    trainer's loggers."""
    jd, td = both
    seen = {}

    def capture(args, cfg, ds, loggers, seed, *a, **k):
        seen["keys"] = sorted(loggers)
        return 0.0

    monkeypatch.setattr(jtrainer, "train_loop", capture)
    jtrainer.train_data(jtrainer.TrainArgs(epochs=0, verbose=False),
                        JConfig(**COMMON), jd)

    cfg = TConfig(**dict(COMMON, dropout=0.2, gnn_drop=0.2, att_drop=0.1))
    args = ttrainer.TrainArgs(epochs=2, batch_size=64, test_batch_size=64,
                              eval_steps=1, verbose=False)
    loggers = {k: ttrainer.ResultsLogger(1) for k in
               ("Hits@20", "Hits@50", "Hits@100", "MRR")}
    losses = []
    best = ttrainer.train_loop(args, cfg, td, loggers, 0, step_losses=losses)
    steps = 2 * -(-len(td.train_pos) // 64)
    assert len(losses) == steps
    assert all(bool(torch.isfinite(x)) and x.dim() == 0 for x in losses)
    assert sorted(loggers) == seen["keys"]
    for lg in loggers.values():
        assert len(lg.results[0]) == 2
        assert all(0.0 <= v <= 1.0 for r in lg.results[0] for v in r)
    assert best == loggers["MRR"].best_valid(0)
    out = ttrainer.train_data(dataclasses.replace(args, epochs=1), cfg, td)
    assert isinstance(out[0], float) and "±" in out[1]


@pytest.mark.parametrize("runs", [1, 3])
def test_results_logger_matches_jax(runs, capsys):
    """best_valid per run and the printed mean +- std over runs (test at
    the best valid epoch), as the JAX package's logger; exact."""
    from lpformer_tpu.utils.logger import ResultsLogger as JLogger

    rng = np.random.default_rng(runs)
    jlog, tlog = JLogger(runs), ttrainer.ResultsLogger(runs)
    for run in range(runs):
        for _ in range(4):
            result = tuple(rng.random(3))
            jlog.add_result(run, result)
            tlog.add_result(run, result)
        assert tlog.best_valid(run) == jlog.best_valid(run)
    want = jlog.print_statistics()
    printed = capsys.readouterr().out
    assert tlog.print_statistics() == want
    assert capsys.readouterr().out == printed


@pytest.mark.parametrize("field,value", [
    ("mesh", "1,1"), ("resume", "ckpt"), ("save_as", "run"),
    ("save_every", 1), ("grad_accum", 2), ("steps_per_call", 4),
    ("mask_input", True), ("heart", True),
])
def test_unported_options_raise(both, field, value, tmp_path):
    """Each option runs one epoch (tests/test_torch_{mask_input,
    grad_accum,checkpoint,parallel}.py hold them to the JAX package);
    ``mesh`` 1,1 runs the sharded step on a mesh of this process alone."""
    _, td = both
    kw = {field: value}
    if field == "resume":
        # a checkpoint of one epoch to resume from, at epoch 2
        first = ttrainer.TrainArgs(epochs=1, save_every=1, verbose=False)
        name = str(tmp_path / "run")
        ttrainer.train_loop(first, TConfig(**COMMON), td, {}, 0, name)
        kw = dict(resume=name + ".latest.ckpt", epochs=2)
    args = ttrainer.TrainArgs(**dict(dict(epochs=1, verbose=False,
                                          checkpoint_dir=str(tmp_path)),
                                     **kw))
    from lpformer_tpu_torch.parallel import distributed

    losses = []
    try:
        assert ttrainer.train_loop(args, TConfig(**COMMON), td, {}, 0,
                                   step_losses=losses) == 0.0
    finally:
        distributed.shutdown()     # the 1 x 1 mesh's process group
    assert losses and all(bool(torch.isfinite(x).all()) for x in losses)
