"""One training step (counterpart of ``lpformer_tpu/train/step.py``),
mirroring the reference batch loop body (reference:
src/train/train_model.py:23-77):

  1. mask the batch's positive edges out of the context adjacency in
     rank space (``ops/masking.py``), and with ``mask_input`` out of the
     propagation adjacency too (their weights set to 0);
  2. uniform-random negatives ``randint`` (reference :64);
  3. positive forward (masked) and negative forward (unmasked);
  4. loss = -mean log(pos + 1e-6) - mean log(1 - neg + 1e-6) (:61,68),
     weighted so the zero-weight padding of a ragged last batch counts
     for nothing; ``loss.backward()``; then the fused clipped-Adam update.

The reference runs two full forwards, each with its own propagation
(``double_propagate=True``). ``double_propagate=False`` shares one
propagation between the halves: the expected loss and gradient are the
same, and with gnn_drop == 0 the step is too. It is the default whenever
``mask_input`` is off; ``mask_input`` gives the halves different
propagation weights, so it propagates twice.

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
from lpformer_tpu_torch.utils import profiling


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
    prop_edge_w: Optional[torch.Tensor] = None,
    double_propagate: bool = False,
    *,
    pos_denom: Optional[torch.Tensor] = None,
    neg_denom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The weighted link-prediction loss of one batch (train mode).
    ``prop_edge_w``: the positive half's propagation weights
    (``mask_input``), which need ``double_propagate``: the negative half
    then propagates over the bundle's own weights. ``pos_denom`` /
    ``neg_denom`` replace the batch's weight sums, so that grad-accum
    micro-batches normalised by the full batch's sums add up to the
    full batch's loss."""
    if double_propagate:
        X_pos = X_neg = None
    else:
        if prop_edge_w is not None:
            raise ValueError("mask_input requires double_propagate (the "
                             "halves see different propagation weights)")
        with profiling.span("train.propagate"):
            X_pos = X_neg = lt.propagate(params, cfg, graph, gen=gen,
                                         train=True)
    with profiling.span("train.forward"):
        h_pos = lt.forward(params, cfg, graph, pos_src, pos_tgt, gen=gen,
                           train=True, mask_ranks=mask_ranks,
                           prop_edge_w=prop_edge_w, X_node=X_pos)
        pos_out = lt.score_links(params, cfg, h_pos, gen=gen, train=True)
        h_neg = lt.forward(params, cfg, graph, neg_src, neg_tgt, gen=gen,
                           train=True, mask_ranks=None, X_node=X_neg)
        neg_out = lt.score_links(params, cfg, h_neg, gen=gen, train=True)

        w = pos_weight
        wsum = w.sum().clamp_min(1.0) if pos_denom is None else pos_denom
        pos_loss = -(torch.log(pos_out + 1e-6) * w).sum() / wsum
        # negatives replicate pos edges num_negative times; weight alike
        nw = w.repeat_interleave(neg_out.shape[0] // w.shape[0])
        nwsum = nw.sum().clamp_min(1.0) if neg_denom is None else neg_denom
        neg_loss = -(torch.log(1.0 - neg_out + 1e-6) * nw).sum() / nwsum
        return pos_loss + neg_loss


def make_train_step(
    cfg: LPFormerConfig,
    optimizer: optim.GradientTransformation,
    num_negative: int = 1,
    mask_input: bool = False,
    double_propagate: Optional[bool] = None,
    grad_accum: int = 1,
    steps_per_call: int = 1,
):
    """The step (state, graph, mult, bin_edge_w, src, tgt, w, gen) ->
    (state, loss): ``mult`` the train-edge multiplicities on the device
    (``LinkPredDataset.mask_mult_device``), ``bin_edge_w`` [E] the
    binarized propagation weights that ``mask_input`` masks, src/tgt/w [B]
    device tensors, ``gen`` a generator on the device.
    ``double_propagate=None`` means ``mask_input``.

    ``grad_accum`` = G splits the batch into G micro-batches (G = 1: the
    whole batch), each with its own forward and ``backward`` (adding into
    ``.grad``), then makes one optimizer update. The positive-edge mask
    and the negatives come from the full batch, and each micro-batch's
    loss is divided by the full batch's weight sums, so a padded ragged
    tail gives the monolithic step's gradient; the step returns the sum
    of the micro-batches' losses. Peak activation memory scales with the
    micro-batch.

    ``steps_per_call`` = K > 1 returns a loop instead: (state, graph,
    mult, bin_edge_w, srcs, tgts, ws, live, gen) -> (state, losses [K]),
    src/tgt/w [K, B] on the device and ``live`` [K] on the host. It runs
    the single step for each live step; a dead step (live == 0, the
    padding of an epoch's last group) draws nothing from ``gen``, leaves
    the parameters, the optimizer state and ``state.step`` untouched, and
    reads loss 0."""
    if double_propagate is None:
        double_propagate = mask_input
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, graph, mult, bin_edge_w, src, tgt, w, gen):
        b = src.shape[0]
        neg = torch.randint(0, graph.num_nodes, (2, b * num_negative),
                            generator=gen, device=src.device,
                            dtype=src.dtype)   # reference train_model.py:64
        mask_ranks = masking.batch_mask_ranks(graph.adj_rows, src, tgt, mult,
                                              weight=w)
        prop_w = None
        if mask_input:
            if graph.edge_rank is None:
                raise ValueError("mask_input needs the bundle's edge_rank "
                                 "(build_graph_bundle(mask_uniq_keys=...))")
            # the reference masks an unweighted adjacency
            # (train_model.py:51-53): bin_edge_w is the binarized weights
            prop_w = masking.mask_edge_weights(mask_ranks, graph.edge_rank,
                                               bin_edge_w)
        if b % grad_accum:
            raise ValueError(f"batch {b} is not divisible by grad_accum "
                             f"{grad_accum}")
        mb, nmb = b // grad_accum, b * num_negative // grad_accum
        pos_denom = w.sum().clamp_min(1.0)
        neg_denom = (w.sum() * num_negative).clamp_min(1.0)
        loss = torch.zeros((), dtype=torch.float32, device=src.device)
        for i in range(grad_accum):
            pos, ng = slice(i * mb, (i + 1) * mb), slice(i * nmb,
                                                         (i + 1) * nmb)
            part = loss_fn(state.params, cfg, graph, src[pos], tgt[pos],
                           neg[0, ng], neg[1, ng], w[pos], mask_ranks, gen,
                           prop_w, double_propagate, pos_denom=pos_denom,
                           neg_denom=neg_denom)
            with profiling.span("train.backward"):
                part.backward()
            loss = loss + part.detach()
        with profiling.span("train.optimizer"):
            grads = optim.tree_map(
                lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                state.params)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            optim.apply_updates(state.params, updates)
            for p in optim.tree_leaves(state.params):
                p.grad = None
        return TrainState(state.params, opt_state, state.step + 1), loss

    if steps_per_call <= 1:
        return step

    def multi_step(state: TrainState, graph, mult, bin_edge_w, srcs, tgts,
                   ws, live, gen):
        losses = []
        for k in range(steps_per_call):
            if live[k] > 0:
                state, loss = step(state, graph, mult, bin_edge_w, srcs[k],
                                   tgts[k], ws[k], gen)
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=srcs.device)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi_step
