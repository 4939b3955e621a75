"""The system under test, ``lpformer_tpu_torch``, as the benchmark drives
it: its graph build, its training step and its citation2 sweep. Every
import of the program is here, inside the functions."""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

MODEL_KEYS = ("dim", "gnn_layers", "num_heads", "trans_layers",
              "pred_layers", "thresh_cn", "thresh_1hop", "thresh_non1hop",
              "residual", "dropout", "gnn_drop", "att_drop", "feat_drop",
              "pred_drop", "matmul_dtype", "budget_combined")


def model_config(cfg: dict):
    from lpformer_tpu_torch.models.config import LPFormerConfig
    return LPFormerConfig(**{k: cfg[k] for k in MODEL_KEYS})


def build_graph(cfg: dict, data: dict, device):
    """The program's host build and its move to the device: the PPR push,
    the train-edge ranks, the graph bundle. Returns (bundle, PPR CSR,
    (train keys, multiplicities), host seconds)."""
    from lpformer_tpu_torch.data.dataset import build_graph_bundle
    from lpformer_tpu_torch.graph import ppr as ppr_mod
    from lpformer_tpu_torch.ops import masking

    t0 = time.perf_counter()
    e, n = data["edges"], cfg["num_nodes"]
    src, dst = e[:, 0], e[:, 1]
    ppr = ppr_mod.ppr_push_csr(np.concatenate([src, dst]),
                               np.concatenate([dst, src]), n, cfg["alpha"],
                               cfg["eps"])
    uniq, mult = masking.train_edge_info(src, dst, n)
    graph = build_graph_bundle(data["x"], src, dst, None, n, ppr,
                               adj_cap=cfg["adj_cap"], ppr_cap=cfg["ppr_cap"],
                               mask_uniq_keys=uniq, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return graph, ppr, (uniq, mult), time.perf_counter() - t0


def train_step(cfg: dict, steps_per_epoch: int):
    """(step, optimizer): the program's training step (one optimizer update
    a call, shared propagation, uniform negatives) and its fused clipped
    Adam, as ``train/trainer.py`` builds them."""
    from lpformer_tpu_torch.train import optim, step

    opt = optim.make_optimizer(cfg["lr"], 0.0, 1.0, steps_per_epoch,
                               clip_norm=1.0)
    return step.make_train_step(model_config(cfg), opt), opt


def train_state(params, opt):
    from lpformer_tpu_torch.train.step import TrainState
    for x in _leaves(params):
        x.requires_grad_(True)
    return TrainState(params, opt.init(params), 0)


def _leaves(tree):
    from lpformer_tpu_torch.train.optim import tree_leaves
    return tree_leaves(tree)


def first_moment(state):
    """The optimizer state's first moment as one flat vector, in the
    parameter tree's order (dict keys sorted, lists in order)."""
    return state.opt_state["m"].detach().clone()


def citation2_dataset(cfg: dict, graph, mask, splits):
    from lpformer_tpu_torch.data.dataset import LinkPredDataset
    (vp, vn), (tp, tn) = splits
    stub = np.zeros((1, 2), np.int64)
    return LinkPredDataset(
        name="citation2-like", num_nodes=cfg["num_nodes"], graph=graph,
        graph_test=graph, train_pos=stub, train_pos_val=stub, valid_pos=vp,
        valid_neg=vn, test_pos=tp, test_neg=tn, metric="MRR",
        mask_uniq_keys=mask[0], mask_mult=mask[1])


@contextlib.contextmanager
def recording_scores():
    """Inside the block, every array of scores the evaluation harness's
    ``score_edges`` returns is appended to the yielded list."""
    from lpformer_tpu_torch.evalx import harness
    out, real = [], harness.score_edges

    def rec(*a, **k):
        s = real(*a, **k)
        out.append(s)
        return s

    harness.score_edges = rec
    try:
        yield out
    finally:
        harness.score_edges = real


def citation2_sweep(cfg: dict, params, ds):
    """One whole evaluation: propagate, score both splits in batches of
    ``test_batch_size``, MRR. Returns {"MRR": (train, valid, test)}."""
    from lpformer_tpu_torch.evalx import harness
    return harness.test_citation2(params, model_config(cfg), ds,
                                  batch_size=cfg["test_batch_size"])


def propagate(cfg: dict, params, graph, gen=None, train=False):
    from lpformer_tpu_torch.models import link_transformer as lt
    return lt.propagate(params, model_config(cfg), graph, gen=gen,
                        train=train)


@contextlib.contextmanager
def recording_pe_attention():
    """Inside the block, every call of the combined-table PE + attention op
    appends (keys shape, w1 shape, key bytes, valid slots as a device
    scalar, whether a backward follows) to the yielded list."""
    from lpformer_tpu_torch.models import link_transformer as lt
    calls, real = [], lt.fused_pe_link_attention_mixed

    def rec(keys, ps, pt, valid, ecls, q, w1, *rest):
        calls.append((tuple(keys.shape), tuple(w1.shape), keys.element_size(),
                      valid.sum(), torch.is_grad_enabled()))
        return real(keys, ps, pt, valid, ecls, q, w1, *rest)

    lt.fused_pe_link_attention_mixed = rec
    try:
        yield calls
    finally:
        lt.fused_pe_link_attention_mixed = real
