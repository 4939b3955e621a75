"""Gradient accumulation and the multi-step loop of the port's training
step, against its own monolithic and sequential steps and against
lpformer_tpu's ``make_train_step(grad_accum=2)`` and ``_iter_step_groups``
(mirroring tests/test_grad_accum.py and tests/test_multi_step.py).

Dropouts are off where two paths are compared: the micro-batches then
differ from the full batch only in float reassociation. Against JAX the
negatives are JAX's own draw, injected. Tolerances, float32
(tests/test_torch_train.py): the loss rtol 1e-5; gradients rtol 5e-4 /
atol 5e-5; parameters after a whole step atol 2 * lr * 1e-2 except on
elements whose gradient is below 1e-6 of the leaf's largest (Adam's
first step moves an element by about lr * sign(g)). The multi-step loop
runs the single step's calls, so it is held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.train import optim as joptim
from lpformer_tpu.train import step as jstep
from lpformer_tpu.train import trainer as jtrainer
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.train import trainer as ttrainer
from lpformer_tpu_torch.utils.params import from_jax_params

KW = dict(seed=0, num_nodes=100, num_train=320, num_eval=24, feat_dim=8)
NO_DROP = dict(dropout=0.0, gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
               pred_drop=0.0)
COMMON = dict(dim=16, gnn_layers=1, budget_cn=16, budget_onehop=32,
              budget_non1hop=32)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
LR = 1e-2
B = 64


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


def _recording(opt, seen):
    """``opt`` with every update's gradients kept in ``seen``."""
    def update(grads, state, params=None):
        seen.append(toptim.tree_map(lambda g: g.detach().clone(), grads))
        return opt.update(grads, state, params)
    return toptim.GradientTransformation(opt.init, update)


def _state(cfg, seed=0):
    params = tlt.init_lpformer(torch.Generator().manual_seed(seed), cfg, 8,
                               device="cpu")
    for p in toptim.tree_leaves(params):
        p.requires_grad_(True)
    opt = toptim.make_optimizer(LR, steps_per_epoch=1)
    return tstep.TrainState(params, opt.init(params), 0), opt


def _batch(ds, live):
    src = torch.as_tensor(ds.train_pos[:B, 0])
    tgt = torch.as_tensor(ds.train_pos[:B, 1])
    w = torch.as_tensor((np.arange(B) < live).astype(np.float32))
    return src, tgt, w


@pytest.mark.parametrize("ga", [2, 4])
@pytest.mark.parametrize("live", [B, 40])   # full batch / padded ragged tail
def test_grad_accum_matches_monolithic(both, ga, live):
    _, td = both
    cfg = TConfig(**COMMON, **NO_DROP)
    src, tgt, w = _batch(td, live)
    bw = (td.graph.edge_w > 0).float()

    def run(g):
        state, opt = _state(cfg)
        seen = []
        step = tstep.make_train_step(cfg, _recording(opt, seen),
                                     grad_accum=g)
        gen = torch.Generator().manual_seed(3)
        st, loss = step(state, td.graph, td.mask_mult_device, bw, src, tgt,
                        w, gen)
        return st, float(loss), toptim.tree_leaves(seen[0])

    st1, l1, g1 = run(1)
    stg, lg, gg = run(ga)
    assert np.isfinite(l1) and st1.step == stg.step == 1
    np.testing.assert_allclose(lg, l1, rtol=1e-5)
    for a, b in zip(gg, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    assert any(float(x.abs().max()) > 0 for x in gg)
    # and the accumulated step repeats itself bit for bit
    st2, l2, _ = run(ga)
    assert l2 == lg
    for a, b in zip(toptim.tree_leaves(st2.params),
                    toptim.tree_leaves(stg.params)):
        assert torch.equal(a, b)


def test_grad_accum_step_matches_jax(both, monkeypatch):
    """One grad_accum=2 step from the same parameters on the same batch
    (a padded tail) and JAX's negatives: the summed loss, the gradients
    (the optimizer's first moment) and the updated parameters."""
    jd, td = both
    jcfg = JConfig(**COMMON, **NO_DROP, use_pallas_attention=True)
    jp = jlt.init_lpformer(jax.random.PRNGKey(3), jcfg, in_dim=8)
    jopt = joptim.make_optimizer(LR, steps_per_epoch=1)
    src, tgt, w = _batch(td, 40)
    rng = jax.random.PRNGKey(5)
    jstate = jstep.TrainState(jp, jopt.init(jp), jnp.asarray(0, jnp.int32))
    bw = (jd.graph.edge_w > 0).astype(jnp.float32)
    jst, jl = jstep.make_train_step(jcfg, jopt, grad_accum=2, donate=False)(
        jstate, jd.graph, jd.mask_mult_device, bw, jnp.asarray(src.numpy()),
        jnp.asarray(tgt.numpy()), jnp.asarray(w.numpy()), rng)
    # JAX's negatives of that step (train/step.py:147-151)
    rng_neg, _ = jax.random.split(jax.random.fold_in(rng, jnp.asarray(0)))
    neg = np.asarray(jax.random.randint(rng_neg, (2, B), 0, KW["num_nodes"],
                                        dtype=jnp.int32))
    monkeypatch.setattr(torch, "randint", lambda *a, **k: torch.as_tensor(
        neg, dtype=k.get("dtype", torch.int64)))

    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for x in toptim.tree_leaves(tp):
        x.requires_grad_(True)
    topt = toptim.make_optimizer(LR, steps_per_epoch=1)
    seen = []
    step = tstep.make_train_step(TConfig(**COMMON, **NO_DROP),
                                 _recording(topt, seen), grad_accum=2)
    tst, tl = step(tstep.TrainState(tp, topt.init(tp), 0), td.graph,
                   td.mask_mult_device, (td.graph.edge_w > 0).float(), src,
                   tgt, w, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tst.opt_state["m"].numpy(),
                               np.asarray(jst.opt_state["m"]), **GRAD_TOL)
    grads = toptim.tree_leaves(seen[0])
    jleaves = jax.tree_util.tree_leaves_with_path(jst.params)
    assert len(jleaves) == len(grads)
    for (path, want), got, g in zip(jleaves, toptim.tree_leaves(tst.params),
                                    grads):
        g = g.numpy()
        settled = np.abs(g) >= 1e-6 * np.abs(g).max()
        np.testing.assert_allclose(
            got.detach().numpy()[settled], np.asarray(want)[settled],
            rtol=0, atol=2 * LR * 1e-2, err_msg=jax.tree_util.keystr(path))


def _stacked(ds, k, b=32):
    src = torch.as_tensor(ds.train_pos[: k * b, 0]).reshape(k, b)
    tgt = torch.as_tensor(ds.train_pos[: k * b, 1]).reshape(k, b)
    return src, tgt, torch.ones((k, b))


def _same_state(a, b):
    assert a.step == b.step
    for x, y in zip(toptim.tree_leaves(a.params), toptim.tree_leaves(b.params)):
        assert torch.equal(x, y)
    for key in ("count", "m", "v", "score_mask"):
        assert torch.equal(a.opt_state[key], b.opt_state[key]), key


def test_multi_step_matches_sequential(both):
    """K steps in one call equal K single steps, bit for bit, with every
    dropout on (the same draws from the generator in the same order)."""
    _, td = both
    cfg = TConfig(**COMMON, dropout=0.2, gnn_drop=0.2, att_drop=0.2,
                  feat_drop=0.2, pred_drop=0.2)
    k = 4
    srcs, tgts, ws = _stacked(td, k)
    bw = (td.graph.edge_w > 0).float()
    state, opt = _state(cfg)
    single = tstep.make_train_step(cfg, opt)
    gen = torch.Generator().manual_seed(3)
    seq = []
    for i in range(k):
        state, loss = single(state, td.graph, td.mask_mult_device, bw,
                             srcs[i], tgts[i], ws[i], gen)
        seq.append(loss)
    state_m, opt = _state(cfg)
    multi = tstep.make_train_step(cfg, opt, steps_per_call=k)
    gen_m = torch.Generator().manual_seed(3)
    state_m, losses = multi(state_m, td.graph, td.mask_mult_device, bw, srcs,
                            tgts, ws, np.ones(k, np.float32), gen_m)
    assert losses.shape == (k,) and torch.equal(losses, torch.stack(seq))
    _same_state(state_m, state)
    assert state_m.step == k
    assert torch.equal(gen.get_state(), gen_m.get_state())


def test_dead_steps_leave_state_untouched(both):
    """Dead (live = 0) steps carrying other batches change nothing: the
    state, the optimizer's count / m / v, the step counter and the
    generator equal a two-step call's."""
    _, td = both
    cfg = TConfig(**COMMON, dropout=0.2, gnn_drop=0.2, att_drop=0.2)
    k = 4
    srcs, tgts, ws = _stacked(td, k)
    bw = (td.graph.edge_w > 0).float()
    st_a, opt = _state(cfg)
    gen_a = torch.Generator().manual_seed(3)
    st_a, losses_a = tstep.make_train_step(cfg, opt, steps_per_call=k)(
        st_a, td.graph, td.mask_mult_device, bw, srcs, tgts, ws,
        np.array([1.0, 1.0, 0.0, 0.0], np.float32), gen_a)
    st_b, opt = _state(cfg)
    gen_b = torch.Generator().manual_seed(3)
    st_b, losses_b = tstep.make_train_step(cfg, opt, steps_per_call=2)(
        st_b, td.graph, td.mask_mult_device, bw, srcs[:2], tgts[:2], ws[:2],
        np.ones(2, np.float32), gen_b)
    _same_state(st_a, st_b)
    assert st_a.step == 2 and int(st_a.opt_state["count"]) == 2
    assert torch.equal(losses_a[:2], losses_b)
    assert torch.equal(losses_a[2:], torch.zeros(2))
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


@pytest.mark.parametrize("n,k", [(70, 3), (64, 4), (10, 2)])
def test_iter_step_groups_matches_jax(n, k):
    train_pos = np.random.default_rng(n).integers(0, 50, size=(n, 2))
    want = list(jtrainer._iter_step_groups(np.random.default_rng(0),
                                           train_pos, 16, k))
    got = list(ttrainer._iter_step_groups(np.random.default_rng(0),
                                          train_pos, 16, k))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert sum(g[2].sum() for g in got) == n
