"""Training loop: epochs, eval schedule, early stopping, multi-seed runs
(counterpart of ``lpformer_tpu/train/trainer.py``).

Mirrors the reference training layer (reference:
src/train/train_model.py:23-182): per-epoch shuffled fixed-size batches
(the ragged last one padded with zero-weight entries), eval every
``eval_steps`` epochs with test-at-best-valid, early stop via ``kill_cnt``,
and a multi-seed outer loop reporting mean +- std.

The device never waits for the host inside an epoch: each epoch's batch
indices and weights go to the device in one copy, and the loss is summed
on the device and fetched once per epoch. Checkpoints
(``utils/checkpoint.py``, the JAX package's file format) carry the
parameters, the optimizer state, the step, the epoch and the seed, for
a true resume.

``mesh`` ("D,G" or "auto") trains and evaluates over a data x graph mesh
of ranks (``parallel/``): every rank runs this loop on the same seeded
batches, the context tables row-sharded over the mesh; rank 0 alone
prints, audits the budgets and writes checkpoints.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lpformer_tpu_torch.data.dataset import LinkPredDataset
from lpformer_tpu_torch.evalx import harness
from lpformer_tpu_torch.models import config as cfg_mod
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.train import optim, step as step_mod
from lpformer_tpu_torch.utils import checkpoint as ckpt
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
    checkpoint_dir: str = "checkpoints"
    verbose: bool = True
    data_name: str = "dataset"
    double_propagate: Optional[bool] = None  # None = auto (two propagations
                                   # only when mask_input requires them)
    resume: Optional[str] = None   # checkpoint path to resume training from
    save_every: int = 0            # also checkpoint every N epochs (crash
                                   # recovery; 0 = only at best valid)
    grad_accum: int = 1            # micro-batches per optimizer step
    mesh: Optional[str] = None     # "D,G" (data x graph): train over a mesh
    context_parallel: bool = False  # shard the context axis over 'graph'
    steps_per_call: int = 1        # optimizer steps per call of the step
                                   # loop (a host loop over K steps)
    audit_budgets: bool = True     # one-shot start-of-training overflow
                                   # audit of the context budget


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


def _iter_step_groups(
    rng: np.random.Generator, train_pos: np.ndarray, batch_size: int, k: int
):
    """Stack batches into groups of ``k`` for the multi-step loop; the last
    group is padded with dead (live=0) steps."""
    srcs, tgts, ws = [], [], []
    for idx, w in _iter_batches(rng, len(train_pos), batch_size):
        srcs.append(train_pos[idx, 0])
        tgts.append(train_pos[idx, 1])
        ws.append(w)
        if len(srcs) == k:
            yield (np.stack(srcs), np.stack(tgts), np.stack(ws),
                   np.ones(k, np.float32))
            srcs, tgts, ws = [], [], []
    if srcs:
        live = np.zeros(k, np.float32)
        live[: len(srcs)] = 1.0
        while len(srcs) < k:
            srcs.append(np.zeros_like(srcs[0]))
            tgts.append(np.zeros_like(tgts[0]))
            ws.append(np.zeros_like(ws[0]))
        yield np.stack(srcs), np.stack(tgts), np.stack(ws), live


def _generator_seed(rng_seed: int, step: int) -> int:
    """The device generator's seed at optimizer step ``step``: the JAX
    package keys its draws by the step, which a checkpoint carries, and
    the port's generator state is not in the file; so a resumed run
    re-seeds from the run's seed and the restored step. A fresh run
    (step 0) seeds with ``rng_seed + 1234``."""
    return rng_seed + 1234 + (step << 32)


def _save(path: str, state: step_mod.TrainState, epoch: int,
          seed: int) -> None:
    """The JAX trainer's checkpoint: exactly its five entries."""
    ckpt.save_checkpoint(path, {
        "params": state.params, "opt_state": state.opt_state,
        "step": np.asarray(state.step, np.int32), "epoch": epoch,
        "seed": seed})


def run_eval(params, cfg: cfg_mod.LPFormerConfig, ds: LinkPredDataset,
             args: TrainArgs, sharded=None) -> Dict[str, tuple]:
    """The harness the dataset needs (reference train_model.py:114-117):
    a citation dataset without HeaRT negatives takes the citation2 sweep,
    every other test_standard. ``sharded``: a ShardedEvalContext, to
    score over its mesh."""
    if "citation" in ds.name.lower() and not ds.heart:
        return harness.test_citation2(params, cfg, ds,
                                      batch_size=args.test_batch_size,
                                      sharded=sharded)
    return harness.test_standard(params, cfg, ds,
                                 batch_size=args.test_batch_size,
                                 k_list=(20, 50, 100), heart=ds.heart,
                                 sharded=sharded)


def parse_mesh(spec: str):
    """'D,G' -> (d, g); 'auto' -> every rank on the data axis."""
    if spec == "auto":
        from lpformer_tpu_torch.parallel import distributed

        return distributed.process_count(), 1
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(f"--mesh expects 'D,G' or 'auto', got {spec!r}")
    return int(parts[0]), int(parts[1])


def _mesh_setup(args: TrainArgs, cfg, ds: LinkPredDataset, optimizer):
    """The mesh branch's pieces (JAX trainer.py:275-311): this rank's
    shards, the eval context and the sharded step."""
    from lpformer_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_train_step, partition_graph,
        place_sharded_graph,
    )
    from lpformer_tpu_torch.parallel.eval import ShardedEvalContext

    if args.grad_accum > 1:
        raise ValueError("--grad-accum is not supported with --mesh")
    d, g = parse_mesh(args.mesh)
    link_dev = d if args.context_parallel else d * g
    for name in ("batch_size", "test_batch_size"):
        if getattr(args, name) % link_dev:
            raise ValueError(f"{name} {getattr(args, name)} must divide "
                             f"over {link_dev} link-sharding devices")
    mesh = make_mesh(data=d, graph=g, device=distributed.rank_device(
        ds.graph.x.device))
    sg = place_sharded_graph(
        partition_graph(ds.graph, g=g, d=d, mask_input=args.mask_input),
        mesh)
    eval_ctx = ShardedEvalContext(cfg, mesh, ds, sg_train=sg,
                                  context_parallel=args.context_parallel)
    step = make_sharded_train_step(
        cfg, optimizer, mesh, ds.num_nodes, sg.rows_per_shard,
        sg.ctx_rows_per_shard, num_negative=args.num_negative,
        context_parallel=args.context_parallel,
        steps_per_call=args.steps_per_call, mask_input=args.mask_input)
    return sg, eval_ctx, step


def train_loop(
    args: TrainArgs,
    cfg: cfg_mod.LPFormerConfig,
    ds: LinkPredDataset,
    loggers: Dict[str, ResultsLogger],
    seed: int,
    model_save_name: Optional[str] = None,
    rng_seed: Optional[int] = None,
    step_losses: Optional[List[torch.Tensor]] = None,
) -> float:
    """One run's training (reference train_model.py:87-140) on the
    dataset's device; returns the best valid metric. ``seed`` is the
    logger's run index; ``rng_seed`` (default: the same) seeds the weights,
    the batch order and the device generator. With ``model_save_name``
    the run writes ``<name>.ckpt`` at every best valid and, with
    ``save_every``, ``<name>.latest.ckpt`` every that many epochs.
    ``args.resume`` restores a checkpoint of either package and goes on
    at its epoch + 1: the batch order restarts from ``rng_seed``, as the
    JAX trainer's does, and the device generator re-seeds from
    ``rng_seed`` and the restored step (``_generator_seed``).
    ``step_losses``, when given, collects every step's loss as a device
    tensor ([K] per call with ``steps_per_call`` = K > 1).

    With ``args.mesh`` every rank of the mesh runs this with the same
    arguments; the dataset may lie on the host, and each rank puts its
    shards on its own device (``parallel.distributed.rank_device``). The
    sharded step's generators derive from the run's seed and the step,
    so a resume needs nothing more."""
    from lpformer_tpu_torch.parallel import distributed

    main_process = distributed.is_coordinator()
    if not main_process:
        args = dataclasses.replace(args, verbose=False)
    if rng_seed is None:
        rng_seed = seed
    if args.audit_budgets and seed == 0 and main_process:
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
    if args.mesh:
        dev = distributed.rank_device(dev)
    params = lt.init_lpformer(torch.Generator().manual_seed(rng_seed), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    steps_per_epoch = max(
        1, (len(ds.train_pos) + args.batch_size - 1) // args.batch_size)
    optimizer = optim.make_optimizer(args.lr, args.l2, args.decay,
                                     steps_per_epoch, clip_norm=1.0)
    state = step_mod.TrainState(params, optimizer.init(params), 0)
    start_epoch = 1
    if args.resume:
        skeleton = {"params": state.params, "opt_state": state.opt_state,
                    "step": torch.zeros((), dtype=torch.int32), "epoch": 0,
                    "seed": 0}
        blob = ckpt.load_checkpoint(args.resume, target=skeleton)
        if blob is None:
            raise FileNotFoundError(
                f"--resume checkpoint not found: {args.resume}")
        if int(blob["seed"]) != seed:
            print(f"WARNING: resuming run {seed} from a checkpoint saved "
                  f"for seed {int(blob['seed'])}", flush=True)
        state = step_mod.TrainState(blob["params"], blob["opt_state"],
                                    int(blob["step"]))
        start_epoch = int(blob["epoch"]) + 1
        if args.verbose:
            print(f"resumed from {args.resume} at epoch {start_epoch}")
    for p in optim.tree_leaves(state.params):
        p.requires_grad_(True)
    mult = ds.mask_mult_device.to(dev)
    eval_ctx = None
    if args.mesh:
        sg, eval_ctx, sharded_step = _mesh_setup(args, cfg, ds, optimizer)
        step_seed = _generator_seed(rng_seed, 0)

        def train_step(state, graph, mult, bin_w, *links_and_gen):
            # the sharded step keys its draws by (seed, step) itself
            return sharded_step(state, sg, mult, *links_and_gen[:-1],
                                step_seed)

        bin_w = None
    else:
        train_step = step_mod.make_train_step(
            cfg, optimizer, num_negative=args.num_negative,
            mask_input=args.mask_input,
            double_propagate=args.double_propagate,
            grad_accum=args.grad_accum, steps_per_call=args.steps_per_call)
        bin_w = (ds.graph.edge_w > 0).float()
    data_rng = np.random.default_rng(rng_seed)
    gen = torch.Generator(device=dev).manual_seed(
        _generator_seed(rng_seed, state.step))
    train_pos = np.asarray(ds.train_pos)
    pos_dev = torch.as_tensor(train_pos).to(dev)
    k = args.steps_per_call

    best_valid, kill_cnt = 0.0, 0
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        total_loss = torch.zeros((), dtype=torch.float32, device=dev)
        if k > 1:
            groups = list(_iter_step_groups(data_rng, train_pos,
                                            args.batch_size, k))
            srcs, tgts, ws = (torch.as_tensor(np.stack([g[i] for g in groups])
                                              ).to(dev) for i in range(3))
            total_examples = float(sum(g[2].sum() for g in groups))
            for j, (*_, live) in enumerate(groups):
                state, losses = train_step(state, ds.graph, mult, bin_w,
                                           srcs[j], tgts[j], ws[j], live, gen)
                if step_losses is not None:
                    step_losses.append(losses)
                total_loss = total_loss + (losses * ws[j].sum(1)).sum()
        else:
            batches = list(_iter_batches(data_rng, len(train_pos),
                                         args.batch_size))
            idx_all = torch.as_tensor(
                np.stack([i for i, _ in batches])).to(dev)
            w_all = torch.as_tensor(np.stack([w for _, w in batches])).to(dev)
            total_examples = float(sum(w.sum() for _, w in batches))
            for j in range(len(batches)):
                links = pos_dev[idx_all[j]]
                state, loss = train_step(state, ds.graph, mult, bin_w,
                                         links[:, 0], links[:, 1], w_all[j],
                                         gen)
                if step_losses is not None:
                    step_losses.append(loss)
                total_loss = total_loss + loss * w_all[j].sum()
        if args.verbose:
            print(f"Epoch {epoch} Loss: "
                  f"{float(total_loss) / total_examples:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)

        if (args.save_every and model_save_name is not None
                and main_process and epoch % args.save_every == 0):
            # periodic crash-recovery checkpoint, paired with resume
            _save(model_save_name + ".latest.ckpt", state, epoch, seed)

        if epoch % args.eval_steps == 0:
            results = run_eval(state.params, cfg, ds, args,
                               sharded=eval_ctx)
            for key_name, result in results.items():
                if key_name in loggers:
                    loggers[key_name].add_result(seed, result)
                if args.verbose and key_name == args.metric:
                    print(f"  {key_name} = {result}", flush=True)
            current = loggers[args.metric].best_valid(seed)
            if current > best_valid:
                kill_cnt = 0
                best_valid = current
                if model_save_name is not None and main_process:
                    _save(model_save_name + ".ckpt", state, epoch, seed)
            else:
                kill_cnt += 1
                if kill_cnt > args.kill_cnt:
                    break
    return best_valid


def train_data(args: TrainArgs, cfg: cfg_mod.LPFormerConfig,
               ds: LinkPredDataset):
    """Multi-seed runs (reference train_model.py:143-182). Returns
    (best valid mean, "valid mean ± std", "test mean ± std"). With
    ``save_as`` each run checkpoints under
    ``<checkpoint_dir>/<data_name>/<save_as>`` (``_seed-<run + 1>`` added
    when there are several runs)."""
    from lpformer_tpu_torch.parallel import distributed

    model_save_name = None
    if args.save_as is not None:
        model_save_name = os.path.join(args.checkpoint_dir, args.data_name,
                                       args.save_as)
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
        run_name = model_save_name
        if model_save_name is not None and args.runs > 1:
            run_name = model_save_name + f"_seed-{run + 1}"
        train_loop(args, cfg, ds, loggers, run, run_name, rng_seed=rng_seed)

    main_process = distributed.is_coordinator()
    if main_process:
        print(args.metric + "\n" + "-" * len(args.metric))
    best_mean, best_var = loggers[args.metric].print_statistics(
        verbose=main_process)
    return (
        best_mean[1],
        f"{best_mean[1]} ± {best_var[1]}",
        f"{best_mean[2]} ± {best_var[2]}",
    )
