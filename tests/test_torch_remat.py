"""Rematerialisation of the pairwise block in the port: the auto rule
against the JAX package's (which shapes turn its ``jax.checkpoint`` on),
remat on against off with every dropout on and one generator seed (the
same loss and gradients, the generator in the same state afterwards, the
fused op's forward run once more a layer), and the port with remat
against JAX with remat.

Tolerances, float32 (tests/test_torch_train.py): against JAX the loss
rtol 1e-5 and gradients rtol 5e-4 / atol 5e-5; remat on against off
exactly, since the recompute runs the same operations on the same inputs
with the same dropout masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.ops import masking as jmask
from lpformer_tpu.ops.context import ContextTables
from lpformer_tpu.train import step as jstep
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.utils.params import from_jax_params

KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)
DROP = dict(dropout=0.3, gnn_drop=0.3, att_drop=0.3, feat_drop=0.3,
            pred_drop=0.3)
NO_DROP = {k: 0.0 for k in DROP}
COMMON = dict(dim=16, gnn_layers=1, thresh_cn=0.0, thresh_1hop=1e-3,
              thresh_non1hop=1e-3, budget_cn=8, budget_onehop=16,
              budget_non1hop=16)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
B = 48


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


def _jax_remats(cfg: JConfig, b: int) -> bool:
    """Whether JAX's calc_pairwise wraps its attention in jax.checkpoint
    at batch ``b``, traced on shapes alone (jax.eval_shape)."""
    c = cfg.budget_cn + cfg.budget_onehop + cfg.budget_non1hop
    sds = jax.ShapeDtypeStruct
    params = jax.eval_shape(lambda k: jlt.init_lpformer(k, cfg, cfg.dim),
                            jax.random.PRNGKey(0))
    ctx = ContextTables(
        ids=sds((b, c), jnp.int32), cls=sds((b, c), jnp.int32),
        src_ppr=sds((b, c), jnp.float32), tgt_ppr=sds((b, c), jnp.float32),
        valid=sds((b, c), jnp.bool_), counts=sds((b, 4), jnp.float32),
        overflow=sds((b,), jnp.int32))
    calls = []
    real = jax.checkpoint

    def spy(fn, *a, **k):
        calls.append(fn)
        return real(fn, *a, **k)

    jax.checkpoint = spy
    try:
        jax.eval_shape(
            lambda p, x, s, t, cx: jlt.calc_pairwise(p, cfg, x, s, t, cx)[0],
            params, sds((1000, cfg.dim), jnp.float32), sds((b,), jnp.int32),
            sds((b,), jnp.int32), ctx)
    finally:
        jax.checkpoint = real
    return bool(calls)


@pytest.mark.parametrize("b,widths,dim,remat", [
    (4096, (128, 320, 320), 256, None),   # ddi-like classic: 3.2e9 bytes
    (4096, (64, 128, 128), 128, None),    # collab-like classic
    (50_000, (20, 40, 40), 100, None),    # exactly 2e9: off
    (50_001, (20, 40, 40), 100, None),    # just past it: on
    (64, (8, 16, 16), 16, True),
    (4096, (128, 320, 320), 256, False),
])
def test_auto_rule_matches_jax(b, widths, dim, remat):
    kw = dict(dim=dim, budget_cn=widths[0], budget_onehop=widths[1],
              budget_non1hop=widths[2], remat_pairwise=remat)
    want = _jax_remats(JConfig(**kw), b)
    assert tlt.remat_pairwise_on(TConfig(**kw), b, sum(widths)) == want


def _params(cfg_kw, pallas=True):
    jcfg = JConfig(**cfg_kw, use_pallas_attention=pallas)
    jp = jlt.init_lpformer(jax.random.PRNGKey(3), jcfg, in_dim=12)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for x in toptim.tree_leaves(tp):
        x.requires_grad_(True)
    return jcfg, jp, tp


def _batch(ds):
    rng = np.random.default_rng(10)
    pos = ds.train_pos[rng.choice(len(ds.train_pos), B, replace=False)]
    w = np.ones(B, np.float32)
    w[-5:] = 0.0
    return pos[:, 0], pos[:, 1], w, rng.integers(0, KW["num_nodes"], (2, B))


def _torch_loss_grads(td, cfg, tp, batch, gen):
    src, tgt, w, neg = (torch.as_tensor(x) for x in batch)
    mr = tmask.batch_mask_ranks(td.graph.adj_rows, src, tgt,
                                td.mask_mult_device, weight=w)
    loss = tstep.loss_fn(tp, cfg, td.graph, src, tgt, neg[0], neg[1], w, mr,
                         gen)
    leaves = toptim.tree_leaves(tp)
    loss.backward()
    grads = [torch.zeros_like(x) if x.grad is None else x.grad.clone()
             for x in leaves]
    for x in leaves:
        x.grad = None
    return loss.detach(), grads


@pytest.mark.parametrize("trans_layers", [1, 2])
def test_remat_matches_no_remat_with_dropouts(both, monkeypatch,
                                              trans_layers):
    _, td = both
    _, _, tp = _params(dict(COMMON, **DROP, trans_layers=trans_layers))
    calls = []
    real = tlt.fused_pe_link_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tlt, "fused_pe_link_attention", counted)
    batch = _batch(td)
    out = {}
    for remat in (False, True):
        cfg = TConfig(**COMMON, **DROP, trans_layers=trans_layers,
                      remat_pairwise=remat)
        gen = torch.Generator().manual_seed(7)
        calls.clear()
        loss, grads = _torch_loss_grads(td, cfg, tp, batch, gen)
        out[remat] = (loss, grads, gen.get_state(), len(calls))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert torch.equal(s0, s1)     # the recompute draws nothing new
    # two forwards (positives, negatives) a layer; remat runs each again
    assert n0 == 2 * trans_layers and n1 == 2 * n0
    # the masks really depend on the seed (dropouts are on)
    other, _ = _torch_loss_grads(td, TConfig(**COMMON, **DROP,
                                             remat_pairwise=True), tp, batch,
                                 torch.Generator().manual_seed(8))
    assert not torch.equal(other, l1)


def test_remat_matches_jax_remat(both):
    jd, td = both
    common = dict(COMMON, **NO_DROP, remat_pairwise=True)
    jcfg, jp, tp = _params(common)
    batch = _batch(td)
    src, tgt, w, neg = (jnp.asarray(x) for x in batch)
    mr = jmask.batch_mask_ranks(jd.graph.adj_rows, src, tgt,
                                jd.mask_mult_device, weight=w)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, g, *a: jstep.loss_fn(p, jcfg, g, *a, None,
                                       jax.random.PRNGKey(0), False)))(
        jp, jd.graph, src, tgt, neg[0], neg[1], w, mr)
    tl, tg = _torch_loss_grads(td, TConfig(**common), tp, batch, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)
