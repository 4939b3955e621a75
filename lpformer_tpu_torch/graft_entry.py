"""Compile-and-run check of the single-device forward (counterpart of
``__graft_entry__.py:entry``).

entry() -> (fn, example_args): the flagship model's forward and link
scores on a batch of 64 train links of a tiny synthetic graph (the JAX
entry's ``_tiny_setup`` shapes: 256 nodes, 900 train edges, 32 features,
dim 32, 2 GCN layers, the classic table of 32 | 64 | 64), on the card
unless ``device`` says otherwise. ``fn(*example_args)`` gives [64]
probabilities.
"""
from __future__ import annotations

import torch


def _tiny_setup(num_nodes=256, num_train=900, feat_dim=32, dim=32,
                device=None):
    from lpformer_tpu_torch.data.synthetic import synthetic_dataset
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.models.config import LPFormerConfig

    ds = synthetic_dataset(
        seed=0,
        num_nodes=num_nodes,
        num_train=num_train,
        num_eval=64,
        feat_dim=feat_dim,
        eps=1e-3,
        device=device,
    )
    cfg = LPFormerConfig(
        dim=dim,
        gnn_layers=2,
        budget_cn=32,
        budget_onehop=64,
        budget_non1hop=64,
    )
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=feat_dim, device=ds.graph.x.device)
    return ds, cfg, params


def entry(device=None):
    """Single-device check: forward + score on a link batch."""
    from lpformer_tpu_torch.models import link_transformer as lt

    ds, cfg, params = _tiny_setup(device=device)

    @torch.no_grad()
    def fn(params, graph, src, tgt):
        h = lt.forward(params, cfg, graph, src, tgt)
        return lt.score_links(params, cfg, h)

    links = torch.as_tensor(ds.train_pos[:64]).to(ds.graph.x.device)
    return fn, (params, ds.graph, links[:, 0], links[:, 1])


if __name__ == "__main__":
    fn, args = entry()
    print("entry:", tuple(fn(*args).shape))
