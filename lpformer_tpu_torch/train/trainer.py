"""Training loop: epochs, eval schedule, early stopping, multi-seed runs
(counterpart of ``lpformer_tpu/train/trainer.py``).

Mirrors the reference training layer (reference:
src/train/train_model.py:23-182): per-epoch shuffled fixed-size batches
(the ragged last one padded with zero-weight entries), eval every
``eval_steps`` epochs with test-at-best-valid, early stop via ``kill_cnt``,
and a multi-seed outer loop reporting mean +- std.

The device never waits for the host inside an epoch: each epoch's batch
indices and weights go to the device in one copy, and the loss is summed
on the device and fetched once per epoch. Checkpoints (``save_as``,
``save_every``, ``resume``), ``mesh``, ``grad_accum`` > 1,
``steps_per_call`` > 1 and ``mask_input`` are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lpformer_tpu_torch.data.dataset import LinkPredDataset
from lpformer_tpu_torch.evalx import harness
from lpformer_tpu_torch.models import config as cfg_mod
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.train import optim, step as step_mod
from lpformer_tpu_torch.utils.logger import ResultsLogger


@dataclasses.dataclass
class TrainArgs:
    """Training-relevant CLI flags (reference run.py:151-202 defaults)."""

    epochs: int = 150
    lr: float = 1e-3
    decay: float = 1.0
    l2: float = 0.0
    batch_size: int = 1024
    test_batch_size: int = 32768
    num_negative: int = 1
    eval_steps: int = 5
    kill_cnt: int = 100
    runs: int = 1
    seed: int = 42
    metric: str = "MRR"
    heart: bool = False
    mask_input: bool = False
    save_as: Optional[str] = None
    verbose: bool = True
    resume: Optional[str] = None
    save_every: int = 0
    grad_accum: int = 1
    mesh: Optional[str] = None
    steps_per_call: int = 1
    audit_budgets: bool = True     # one-shot start-of-training overflow
                                   # audit of the context budget


def _refuse_unported(args: TrainArgs) -> None:
    unported = {
        "mesh": args.mesh is not None,
        "resume": args.resume is not None,
        "save_as": args.save_as is not None,
        "save_every": args.save_every != 0,
        "grad_accum > 1": args.grad_accum > 1,
        "steps_per_call > 1": args.steps_per_call > 1,
        "mask_input": args.mask_input,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"not ported yet: {', '.join(asked)}")


def overflow_audit(ds: LinkPredDataset, cfg: cfg_mod.LPFormerConfig,
                   sample: int = 2048):
    """One-shot budget-overflow audit on a sample of train links, on the
    dataset's device. Returns (link_overflow_rate, entry_overflow_rate):
    the fraction of links whose context sets the static budget truncated,
    and the fraction of context entries dropped. The reference has no
    budgets, so a nonzero overflow is an approximation that must be
    surfaced, not silent."""
    from lpformer_tpu_torch.ops.context import extract_context

    tp = np.asarray(ds.train_pos)
    take = min(sample, len(tp))
    idx = np.random.default_rng(0).choice(len(tp), take, replace=False)
    dev = ds.graph.x.device
    links = torch.as_tensor(tp[idx]).to(dev)
    with torch.no_grad():
        ctx = extract_context(ds.graph.adj_rows, ds.graph.ppr_rows,
                              links[:, 0], links[:, 1], cfg.context)
    over = ctx.overflow.cpu().numpy()
    kept = int(ctx.valid.sum())
    dropped = int(over.sum())
    return float((over > 0).mean()), dropped / max(kept + dropped, 1)


def _iter_batches(rng: np.random.Generator, n: int, batch_size: int):
    """Shuffled fixed-size batches; last batch padded (weight 0)."""
    perm = rng.permutation(n)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        idx = perm[lo:hi]
        w = np.ones(batch_size, np.float32)
        if hi - lo < batch_size:
            pad = np.zeros(batch_size - (hi - lo), dtype=idx.dtype)
            idx = np.concatenate([idx, pad])
            w[hi - lo:] = 0.0
        yield idx, w


def run_eval(params, cfg: cfg_mod.LPFormerConfig, ds: LinkPredDataset,
             args: TrainArgs) -> Dict[str, tuple]:
    """The harness the dataset needs (reference train_model.py:114-117):
    a citation dataset without HeaRT negatives takes the citation2 sweep,
    every other test_standard."""
    if "citation" in ds.name.lower() and not ds.heart:
        return harness.test_citation2(params, cfg, ds,
                                      batch_size=args.test_batch_size)
    return harness.test_standard(params, cfg, ds,
                                 batch_size=args.test_batch_size,
                                 k_list=(20, 50, 100), heart=ds.heart)


def train_loop(
    args: TrainArgs,
    cfg: cfg_mod.LPFormerConfig,
    ds: LinkPredDataset,
    loggers: Dict[str, ResultsLogger],
    seed: int,
    rng_seed: Optional[int] = None,
    step_losses: Optional[List[torch.Tensor]] = None,
) -> float:
    """One run's training (reference train_model.py:87-140) on the
    dataset's device; returns the best valid metric. ``seed`` is the
    logger's run index; ``rng_seed`` (default: the same) seeds the weights,
    the batch order and the device generator. ``step_losses``, when given,
    collects every step's loss as a device tensor."""
    _refuse_unported(args)
    if rng_seed is None:
        rng_seed = seed
    if args.audit_budgets and seed == 0:
        link_rate, entry_rate = overflow_audit(ds, cfg)
        if args.verbose or link_rate > 0.005:
            budgets = (f"budget_combined={cfg.budget_combined}"
                       if cfg.budget_combined is not None else
                       f"budgets cn={cfg.budget_cn} onehop="
                       f"{cfg.budget_onehop} non1hop={cfg.budget_non1hop}")
            print(f"[budgets] context overflow: {link_rate:.2%} of links "
                  f"truncated, {entry_rate:.2%} of entries dropped "
                  f"({budgets})", flush=True)
        if link_rate > 0.005:
            print("[budgets] WARNING: >0.5% of links exceed the static "
                  "context budget; compaction keeps the top-by-PPR "
                  "entries, but metrics may degrade.", flush=True)
    dev = ds.graph.x.device
    params = lt.init_lpformer(torch.Generator().manual_seed(rng_seed), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    for p in optim.tree_leaves(params):
        p.requires_grad_(True)
    steps_per_epoch = max(
        1, (len(ds.train_pos) + args.batch_size - 1) // args.batch_size)
    optimizer = optim.make_optimizer(args.lr, args.l2, args.decay,
                                     steps_per_epoch, clip_norm=1.0)
    state = step_mod.TrainState(params, optimizer.init(params), 0)
    train_step = step_mod.make_train_step(cfg, optimizer,
                                          num_negative=args.num_negative)
    mult = ds.mask_mult_device
    data_rng = np.random.default_rng(rng_seed)
    gen = torch.Generator(device=dev).manual_seed(rng_seed + 1234)
    train_pos = np.asarray(ds.train_pos)
    pos_dev = torch.as_tensor(train_pos).to(dev)

    best_valid, kill_cnt = 0.0, 0
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        batches = list(_iter_batches(data_rng, len(train_pos),
                                     args.batch_size))
        idx_all = torch.as_tensor(np.stack([i for i, _ in batches])).to(dev)
        w_all = torch.as_tensor(np.stack([w for _, w in batches])).to(dev)
        total_loss = torch.zeros((), dtype=torch.float32, device=dev)
        total_examples = 0.0
        for j, (_, w) in enumerate(batches):
            links = pos_dev[idx_all[j]]
            state, loss = train_step(state, ds.graph, mult, links[:, 0],
                                     links[:, 1], w_all[j], gen)
            if step_losses is not None:
                step_losses.append(loss)
            n_real = float(w.sum())
            total_loss = total_loss + loss * n_real
            total_examples += n_real
        if args.verbose:
            print(f"Epoch {epoch} Loss: "
                  f"{float(total_loss) / total_examples:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)

        if epoch % args.eval_steps == 0:
            results = run_eval(state.params, cfg, ds, args)
            for key_name, result in results.items():
                if key_name in loggers:
                    loggers[key_name].add_result(seed, result)
                if args.verbose and key_name == args.metric:
                    print(f"  {key_name} = {result}", flush=True)
            current = loggers[args.metric].best_valid(seed)
            if current > best_valid:
                kill_cnt = 0
                best_valid = current
            else:
                kill_cnt += 1
                if kill_cnt > args.kill_cnt:
                    break
    return best_valid


def train_data(args: TrainArgs, cfg: cfg_mod.LPFormerConfig,
               ds: LinkPredDataset):
    """Multi-seed runs (reference train_model.py:143-182). Returns
    (best valid mean, "valid mean ± std", "test mean ± std")."""
    _refuse_unported(args)
    loggers = {
        "Hits@20": ResultsLogger(args.runs),
        "Hits@50": ResultsLogger(args.runs),
        "Hits@100": ResultsLogger(args.runs),
    }
    if args.metric == "MRR" or ds.heart or "citation" in ds.name.lower():
        loggers["MRR"] = ResultsLogger(args.runs)

    for run in range(args.runs):
        # reference semantics (train_model.py:147,165-167): a single run
        # uses args.seed; multi-run sweeps re-seed with the run index
        rng_seed = args.seed if args.runs == 1 else run
        train_loop(args, cfg, ds, loggers, run, rng_seed=rng_seed)

    print(args.metric + "\n" + "-" * len(args.metric))
    best_mean, best_var = loggers[args.metric].print_statistics()
    return (
        best_mean[1],
        f"{best_mean[1]} ± {best_var[1]}",
        f"{best_mean[2]} ± {best_var[2]}",
    )
