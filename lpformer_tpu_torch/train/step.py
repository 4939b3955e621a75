"""One training step (counterpart of ``lpformer_tpu/train/step.py``),
mirroring the reference batch loop body (reference:
src/train/train_model.py:23-77):

  1. mask the batch's positive edges out of the context adjacency in
     rank space (``ops/masking.py``);
  2. uniform-random negatives ``randint`` (reference :64);
  3. one shared propagation (the JAX package's ``double_propagate=False``,
     its default whenever ``mask_input`` is off); the expected loss and
     gradient equal the reference's two propagations, and with
     gnn_drop == 0 the step is identical;
  4. positive forward (masked) and negative forward (unmasked);
  5. loss = -mean log(pos + 1e-6) - mean log(1 - neg + 1e-6) (:61,68),
     weighted so the zero-weight padding of a ragged last batch counts
     for nothing; ``loss.backward()``; then the fused clipped-Adam update.

Randomness (negatives, dropout, attention subsampling) comes from one
``torch.Generator`` on the device, drawn in a fixed order. The step returns
the loss as a device tensor; nothing in it waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.ops import masking
from lpformer_tpu_torch.train import optim


class TrainState(NamedTuple):
    params: dict          # leaves require grad; updated in place
    opt_state: dict       # the fused optimizer's {count, m, v, score_mask}
    step: int


def loss_fn(
    params,
    cfg: LPFormerConfig,
    graph,
    pos_src,
    pos_tgt,
    neg_src,
    neg_tgt,
    pos_weight,
    mask_ranks,
    gen: Optional[torch.Generator],
) -> torch.Tensor:
    """The weighted link-prediction loss of one batch (train mode), with
    one propagation shared by both forwards. The JAX package's
    ``prop_edge_w`` argument serves ``--mask-input``, and its
    ``double_propagate`` and ``pos_denom`` / ``neg_denom`` serve
    ``--mask-input`` and ``grad_accum``, none of which is ported."""
    X = lt.propagate(params, cfg, graph, gen=gen, train=True)
    h_pos = lt.forward(params, cfg, graph, pos_src, pos_tgt, gen=gen,
                       train=True, mask_ranks=mask_ranks, X_node=X)
    pos_out = lt.score_links(params, cfg, h_pos, gen=gen, train=True)
    h_neg = lt.forward(params, cfg, graph, neg_src, neg_tgt, gen=gen,
                       train=True, mask_ranks=None, X_node=X)
    neg_out = lt.score_links(params, cfg, h_neg, gen=gen, train=True)

    w = pos_weight
    pos_loss = -(torch.log(pos_out + 1e-6) * w).sum() / w.sum().clamp_min(1.0)
    # negatives replicate pos edges num_negative times; weight alike
    nw = w.repeat_interleave(neg_out.shape[0] // w.shape[0])
    nwsum = nw.sum().clamp_min(1.0)
    neg_loss = -(torch.log(1.0 - neg_out + 1e-6) * nw).sum() / nwsum
    return pos_loss + neg_loss


def make_train_step(
    cfg: LPFormerConfig,
    optimizer: optim.GradientTransformation,
    num_negative: int = 1,
):
    """The step (state, graph, mult, src, tgt, w, gen) -> (state, loss):
    ``mult`` the train-edge multiplicities on the device
    (``LinkPredDataset.mask_mult_device``), src/tgt/w [B] device tensors,
    ``gen`` a generator on the device. The JAX package's ``mask_input``,
    ``grad_accum`` and ``steps_per_call`` are not ported."""

    def step(state: TrainState, graph, mult, src, tgt, w, gen):
        b = src.shape[0]
        neg = torch.randint(0, graph.num_nodes, (2, b * num_negative),
                            generator=gen, device=src.device,
                            dtype=src.dtype)   # reference train_model.py:64
        mask_ranks = masking.batch_mask_ranks(graph.adj_rows, src, tgt, mult,
                                              weight=w)
        loss = loss_fn(state.params, cfg, graph, src, tgt, neg[0], neg[1], w,
                       mask_ranks, gen)
        loss.backward()
        grads = optim.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        optim.apply_updates(state.params, updates)
        for p in optim.tree_leaves(state.params):
            p.grad = None
        return TrainState(state.params, opt_state, state.step + 1), \
            loss.detach()

    return step
