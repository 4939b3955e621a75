"""The ppa-like slice on the card (``cuda``: each test skips itself without
one; no JAX here, the plain torch versions are the reference): rows 1-3 at
the ppa-like widths (B 32768, C 96, O = dh = 64, bf16) on near-full tables,
held to their plain versions at chip_smoke.py's bounds (TOL and BWD_TOL,
through its own checks; the scatter to profile_kernels.SCATTER_TOL of the
largest row abs-sum), and the residual GCN's propagation, forward and
backward, over a BlockedBELL of kb 5 against the same graph's BucketedELL.

    python -m pytest tests/test_torch_ppa_card.py -q -m cuda -s

The propagation tolerance: f32, the two layouts sum each node's messages
in other orders (tests/test_torch_blocked.py holds every SpMM layout to
rtol 1e-5 / atol 1e-6), carried through three layers' LayerNorm and
residual adds: X to rtol 1e-4 / atol 1e-5, and each GCN weight's gradient,
a sum over every node that cancels, by its relative L2 error to
chip_smoke.py's STEP_F32_GRAD_TOL (1e-4).
"""
import dataclasses

import pytest
import torch

import chip_smoke as cs
from lpformer_tpu_torch import presets
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.graph.containers import BlockedBELL
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.ops import scatter
from lpformer_tpu_torch.profile_kernels import SCATTER_TOL
from lpformer_tpu_torch.train import optim
from lpformer_tpu_torch.utils import measure


def _near_full(g, b, c):
    """Valid slots per link: c - 8 to c, every table nearly full."""
    return torch.randint(c - 8, c + 1, (b,), generator=g, device=g.device)


FILLS = {"every slot valid": measure.full_link_counts,
         "c - 8 to c valid": _near_full}


@pytest.mark.cuda
@pytest.mark.parametrize("fill", list(FILLS))
def test_rows_1_to_3_hold_at_ppa_widths_on_card(fill):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, b = presets.PPA_LIKE_CONFIG, presets.PPA_LIKE_BATCH
    c = cfg.budget_combined
    t = cs.tables()["combined"]
    t["module"]._load()
    t["module"]._load_bwd()
    a = measure.kernel_inputs("cuda", torch.bfloat16, b=b, c=c, o=cfg.dim,
                              dh=cfg.dim, counts=FILLS[fill])
    cs._fwd_check("combined", t, a, torch.bfloat16, f"ppa-like, {fill}",
                  (1, 1))
    cs._bwd_check_timed("combined", t, measure.bwd_inputs(a),
                        torch.bfloat16, f"ppa-like, {fill}", (1, 1))
    ids, ct, n, live = measure.scatter_inputs(
        "cuda", b=b, c=c, d=cfg.dim, n=presets.PPA_LIKE_DATA["num_nodes"] + 1,
        counts=FILLS[fill])
    before = scatter.scatter_rows_add.launches
    got = scatter.scatter_rows_add(ids, ct, n, live)
    assert scatter.scatter_rows_add.launches == before + 1
    want = scatter.scatter_rows_add_plain(ids, ct, n, live)
    scale = float(scatter.scatter_rows_add_plain(ids, ct.float().abs(), n,
                                                 live).max())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= SCATTER_TOL * scale


@pytest.mark.cuda
def test_residual_bbell_propagate_matches_bell_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = synthetic_dataset(seed=1, num_nodes=3000, num_train=60_000,
                           num_eval=10, feat_dim=64, eps=1e-3, device="cuda")
    g = ds.graph
    assert g.ell is not None and g.bbell is None
    bb = BlockedBELL.from_coo(g.edge_src.cpu().numpy(),
                              g.edge_dst.cpu().numpy(), g.num_nodes,
                              g.w_norm.cpu().numpy(), block=640).to("cuda")
    assert bb.kb == 5
    tiled = dataclasses.replace(g, ell=None, bbell=bb)
    cfg = LPFormerConfig(dim=64, gnn_layers=3, residual=True,
                         budget_combined=96, gnn_drop=0.0, dropout=0.0)
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=64, device="cuda")
    leaves = optim.tree_leaves(params["node_encoder"])
    for x in leaves:
        x.requires_grad_(True)
    r = torch.randn(g.num_nodes, cfg.dim, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    outs = []
    for graph in (g, tiled):
        X = lt.propagate(params, cfg, graph)
        outs.append((X.detach(),
                     torch.autograd.grad((X * r).sum(), leaves)))
    (x_bell, g_bell), (x_bb, g_bb) = outs
    torch.testing.assert_close(x_bb, x_bell, rtol=1e-4, atol=1e-5)
    for got, want in zip(g_bb, g_bell):
        assert float((got - want).norm() / want.norm()) <= \
            cs.STEP_F32_GRAD_TOL
