"""One training step's gradients on the card with the combined table's
fused PE+attention op (``MixedOp``) built from each pair of its halves,
kernel or plain version, against the plain pair, on the ddi-like preset
(dim 256) at several draws.

The op's backward recomputes each valid slot's xj and reads the forward's
saved m, l and out, so where its two halves sum xj in different orders
the softmax's gradient no longer cancels bit for bit. The forward kernel
walks a link's slots on CUDA cores and the tile backward sums xj on the
tensor cores, so the kernel pair's gradients differ from the plain
pair's most at ``att_layers/0/lin_l/w``, the weight that makes the
queries; a pair of halves that share one order does not show it. The
test holds every pair (kernel / kernel, kernel / plain, plain / kernel)
to chip_smoke.py's step tolerances at each draw (params, negatives and
train links from the draw's seed; draw 0 is chip_smoke.py's own), with
dropout off and the plain scatter-add so only the op's halves differ.
Run with ``-s`` to see each pair's readings.

Tolerances: chip_smoke.py's STEP_LOSS_TOL (|loss difference| 1e-3) and
STEP_GRAD_TOL (2e-2 relative L2 per gradient leaf).
"""
import dataclasses

import pytest
import torch

STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-3, 2e-2
Q_LEAF = ("att_layers", 0, "lin_l", "w")


@pytest.fixture(scope="module")
def ddi_like():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.data.synthetic import synthetic_dataset

    ds = synthetic_dataset(**presets.DDI_LIKE_DATA, device="cuda")
    cfg = dataclasses.replace(presets.DDI_LIKE_CONFIG, dropout=0.0,
                              gnn_drop=0.0, att_drop=0.0)
    return ds, cfg, presets.DDI_LIKE_BATCH


def _pairs():
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam

    kernel = (pam._fwd, pam.fused_pe_link_attention_mixed_bwd)
    plain = (pam.fused_pe_link_attention_mixed_plain,
             pam.fused_pe_link_attention_mixed_bwd_plain)
    return plain, {"kernel fwd + kernel bwd": kernel,
                   "kernel fwd + plain bwd": (kernel[0], plain[1]),
                   "plain fwd + kernel bwd": (plain[0], kernel[1])}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_op_pairs_match_plain_pair_in_a_ddi_like_step(ddi_like, seed,
                                                      monkeypatch):
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops import masking, scatter
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam
    from lpformer_tpu_torch.train import optim, step as step_mod

    ds, cfg, batch = ddi_like
    dev = torch.device("cuda")
    params = lt.init_lpformer(torch.Generator().manual_seed(seed), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    leaves = optim.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    paths = [p for p, _ in optim.tree_leaves_with_path(params)]
    pos = torch.as_tensor(ds.train_pos[seed * batch:(seed + 1) * batch]).to(
        dev)
    neg = torch.randint(0, ds.num_nodes, (2, batch),
                        generator=torch.Generator().manual_seed(seed + 1)
                        ).to(dev)
    w = torch.ones(batch, device=dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)
    monkeypatch.setattr(scatter, "scatter_rows_add",
                        scatter.scatter_rows_add_plain)

    def step(pair):
        monkeypatch.setattr(lt, "fused_pe_link_attention_mixed",
                            lambda *a: pam.MixedOp.apply(*pair, *a))
        loss = step_mod.loss_fn(params, cfg, ds.graph, pos[:, 0], pos[:, 1],
                                neg[0], neg[1], w, mr, None)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    plain, pairs = _pairs()
    loss_p, ref = step(plain)
    q = paths.index(Q_LEAF)
    bad = []
    for name, pair in pairs.items():
        loss, grads = step(pair)
        rel = [float((a - r).norm() / r.norm().clamp_min(1e-30))
               for a, r in zip(grads, ref)]
        i = rel.index(max(rel))
        print(f"ddi-like draw {seed} {name}: |loss diff| "
              f"{abs(loss - loss_p):.2e}; max rel L2 {rel[i]:.3e} at "
              f"{'/'.join(map(str, paths[i]))}; "
              f"{'/'.join(map(str, Q_LEAF))} {rel[q]:.3e}")
        if abs(loss - loss_p) > STEP_LOSS_TOL or rel[i] > STEP_GRAD_TOL:
            bad.append((name, abs(loss - loss_p), rel[i], paths[i]))
    assert not bad, bad
