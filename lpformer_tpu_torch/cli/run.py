"""CLI runner, flag-compatible with the reference and with the JAX
package's CLI (counterpart of ``lpformer_tpu/cli/run.py``).

The same flags, dests and defaults as ``lpformer_tpu.cli.run`` (reference
src/run.py:150-211, plus the context budgets), and the same
``configs/*.json``. The device is CUDA unless ``--platform cpu`` asks
for the CPU. ``--jax-cache-dir`` is accepted and means nothing here;
``--no-pallas-attention`` takes the dense attention route
(``models/link_transformer.py``), and ``--dump-att`` with ``--save-as``
writes the best checkpoint's attention weights over the test positives to
``attention_weights.npz``.

``--mesh D,G`` trains and evaluates over a data x graph mesh of D*G
ranks, a process each (``parallel/``). Without the multi-process flags
the command spawns the D*G ranks on this host itself, one per visible GPU
(fewer GPUs than ranks raise), or gloo processes under ``--platform cpu``.
Across hosts, or under a launcher, every rank runs the command with
``--coordinator host:port --num-processes D*G --process-id r`` (the
process count counts ranks, not hosts as in the JAX CLI), or with
``--distributed auto`` under torchrun. Rank 0 prints and writes the
checkpoints.

Usage:
  python -m lpformer_tpu_torch.cli.run --config ogbl-collab-existing
  python -m lpformer_tpu_torch.cli.run --data_name synthetic \\
      --platform cpu --epochs 3                                # smoke
  python -m lpformer_tpu_torch.cli.run --data_name synthetic \\
      --platform cpu --mesh 2,2 --epochs 1                      # 4 ranks
  torchrun --nproc-per-node 4 -m lpformer_tpu_torch.cli.run --mesh 2,2 \\
      --distributed auto --config ogbl-collab-existing
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None,
                   help="JSON config: a path, or a name under configs/ "
                        "(e.g. 'ogbl-collab-existing'). Explicit CLI flags "
                        "override config values.")
    p.add_argument("--matmul-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: bf16 matmul inputs + bf16 key tables "
                        "and gathers, f32 softmax/accumulation")
    # (reference run.py:151-202)
    p.add_argument("--data_name", type=str, default="ogbl-collab")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--mask-input", action="store_true", default=False)
    p.add_argument("--non-verbose", action="store_true", default=False)

    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--tlayers", type=int, default=1)
    p.add_argument("--num-heads", type=int, default=1)
    p.add_argument("--gnn-layers", type=int, default=2)
    p.add_argument("--pred-layers", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--gnn-drop", type=float, default=0.2)
    p.add_argument("--att-drop", type=float, default=0.1)
    p.add_argument("--pred-drop", type=float, default=0)
    p.add_argument("--feat-drop", type=float, default=0)
    p.add_argument("--residual", action="store_true", default=False)
    p.add_argument("--no-layer-norm", action="store_true", default=False)
    p.add_argument("--no-relu", action="store_true", default=False)

    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--decay", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--test-batch-size", type=int, default=32768)
    p.add_argument("--num-negative", type=int, default=1)
    p.add_argument("--eval_steps", type=int, default=5)
    p.add_argument("--kill_cnt", dest="kill_cnt", default=100, type=int)
    p.add_argument("--l2", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--use-val-in-test", action="store_true", default=False)
    p.add_argument("--heart", action="store_true", default=False)
    p.add_argument("--save-as", type=str, default=None)
    p.add_argument("--metric", type=str, default=None,
                   help="eval metric for model selection (default: the "
                        "reference's per-dataset choice, run.py:102-120; "
                        "an explicit value wins)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints",
                   help="root directory for checkpoint save/load "
                        "(reference hard-codes 'checkpoints/', "
                        "utils.py:25)")
    p.add_argument("--eps", type=float, default=1e-4)
    p.add_argument("--thresh-cn", type=float, default=0)
    p.add_argument("--thresh-1hop", type=float, default=1e-2)
    p.add_argument("--thresh-non1hop", type=float, default=1e-2)

    # additions of the JAX package's CLI
    p.add_argument("--data-dir", type=str, default="dataset")
    p.add_argument("--platform", type=str, default=None,
                   help="cpu, or gpu / cuda (the default: CUDA, which must "
                        "be present)")
    p.add_argument("--jax-cache-dir", type=str,
                   default=os.environ.get(
                       "JAX_COMPILATION_CACHE_DIR",
                       os.path.join("~", ".cache", "lpformer_tpu",
                                    "jax_cache")),
                   help="accepted for the JAX CLI's command lines; unused")
    p.add_argument("--budget-cn", type=int, default=None)
    p.add_argument("--budget-onehop", type=int, default=None)
    p.add_argument("--budget-non1hop", type=int, default=None)
    p.add_argument("--budget-combined", type=str, default=None,
                   help="combined (class-tagged) context table: one "
                        "cross-class budget replacing the per-class "
                        "blocks. An int, or 'auto' = p99.9 of the "
                        "measured TOTAL per-link count. Default: off "
                        "(per-class blocks)")
    p.add_argument("--adj-cap", type=int, default=None)
    p.add_argument("--ppr-cap", type=int, default=None)
    p.add_argument("--single-propagate", action="store_true", default=False,
                   help="share one GCN propagation across pos/neg halves "
                        "(the default whenever --mask-input is off)")
    p.add_argument("--double-propagate", action="store_true", default=False,
                   help="force two full propagations per step (bit-exact "
                        "reference emulation)")
    p.add_argument("--save-every", type=int, default=0,
                   help="also checkpoint every N epochs (crash recovery)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume training from")
    p.add_argument("--pallas-attention", dest="pallas_attention",
                   action="store_true", default=None,
                   help="the fused PE+attention op (the default where "
                        "num_heads == 1)")
    p.add_argument("--no-pallas-attention", dest="pallas_attention",
                   action="store_false",
                   help="the dense masked attention route")
    p.add_argument("--context-parallel", action="store_true",
                   help="with --mesh: shard each link's context set over "
                        "the 'graph' axis (merged two-pass softmax)")
    p.add_argument("--mesh", type=str, default=None,
                   help="'D,G' (data x graph) or 'auto': train + eval over "
                        "a mesh of D*G ranks with row-sharded context "
                        "state")
    # multi-process bring-up (parallel/distributed.py)
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port (the same on every "
                        "rank; rank 0 serves it)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total number of ranks (D*G)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this rank (0-based; 0 owns checkpoint writes and "
                        "logging)")
    p.add_argument("--distributed", type=str, default=None,
                   choices=["auto"],
                   help="'auto': torchrun's environment (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per optimizer step (memory cap)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per call of the step loop")
    p.add_argument("--dump-att", action="store_true", default=False,
                   help="after training, dump attention weights over the "
                        "test positives to attention_weights.npz")
    # synthetic-dataset knobs (smoke tests / benches)
    p.add_argument("--syn-nodes", type=int, default=2000)
    p.add_argument("--syn-edges", type=int, default=10000)
    p.add_argument("--syn-feat", type=int, default=64)
    # accepted for drop-in compatibility with the reference CLI, which
    # parses them and never reads them (reference: src/run.py:181-196);
    # --device selects a CUDA index there (here: --platform)
    for flag in ("--output_dir", "--bymetric"):
        p.add_argument(flag, type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--percentile", type=float, default=75,
                   help=argparse.SUPPRESS)
    p.add_argument("--log_steps", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--device", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--remove-pos-edges", action="store_true",
                   default=False, help=argparse.SUPPRESS)
    return p


def resolve_platform(platform):
    """--platform as a device: None (CUDA, which must exist), "cpu", or
    "cuda" for "gpu" / "cuda"."""
    if platform is None or platform == "cpu":
        return platform
    if platform in ("gpu", "cuda"):
        return "cuda"
    raise ValueError(f"--platform {platform!r}: this port runs on 'cpu' "
                     f"or 'gpu' / 'cuda'")


def load_dataset(args, device=None):
    name = args.data_name.lower()
    if name == "synthetic":
        from lpformer_tpu_torch.data.synthetic import synthetic_dataset

        return synthetic_dataset(
            seed=args.seed,
            num_nodes=args.syn_nodes,
            num_train=args.syn_edges,
            num_eval=max(args.syn_edges // 20, 10),
            feat_dim=args.syn_feat,
            eps=args.eps,
            heart=args.heart,
            mask_input=args.mask_input,
            # uncapped rows on a dense synthetic PPR (cap ~ N) would make
            # the context extraction's per-link row work quadratic in N
            adj_cap=args.adj_cap if args.adj_cap is not None else 96,
            ppr_cap=args.ppr_cap if args.ppr_cap is not None else 256,
            device=device,
        )
    if name in ("cora", "citeseer", "pubmed", "chameleon", "squirrel"):
        from lpformer_tpu_torch.data.planetoid import read_data_planetoid

        return read_data_planetoid(
            args.data_name, data_dir=args.data_dir, eps=args.eps,
            heart=args.heart, seed=args.seed,
            adj_cap=args.adj_cap, ppr_cap=args.ppr_cap,
            mask_input=args.mask_input, device=device,
        )
    from lpformer_tpu_torch.data.ogb import read_data_ogb

    return read_data_ogb(
        args.data_name, data_dir=args.data_dir, eps=args.eps,
        heart=args.heart, use_val_in_test=args.use_val_in_test,
        dim_for_featureless=args.dim, seed=args.seed,
        adj_cap=args.adj_cap, ppr_cap=args.ppr_cap,
        mask_input=args.mask_input, device=device,
    )


def default_metric(args) -> str:
    # (reference run.py:102-120)
    if args.heart:
        return "MRR"
    return {
        "ogbl-collab": "Hits@50",
        "ogbl-ddi": "Hits@20",
        "ogbl-ppa": "Hits@100",
        "ogbl-citation2": "MRR",
    }.get(args.data_name, "MRR")


def build_config(args, ds):
    """The model config of the flags; budgets not given are measured on
    the dataset (p99.9 of exact per-class counts over sampled train
    links, ``utils/budgets.py``), and ``--budget-combined auto`` measures
    the combined table's."""
    from lpformer_tpu_torch.models.config import LPFormerConfig
    from lpformer_tpu_torch.utils.budgets import derive_budgets

    budgets = (args.budget_cn, args.budget_onehop, args.budget_non1hop)
    if any(b is None for b in budgets):
        derived = derive_budgets(
            ds, args.thresh_cn, args.thresh_1hop, args.thresh_non1hop
        )
        budgets = tuple(
            b if b is not None else d for b, d in zip(budgets, derived)
        )
        if not args.non_verbose:
            print(
                f"[budgets] measured for {ds.name}: "
                f"cn={budgets[0]} onehop={budgets[1]} "
                f"non1hop={budgets[2]} (p99.9 of sampled exact "
                f"counts; override with --budget-*)",
                flush=True,
            )
    bc = args.budget_combined
    if bc == "auto":
        bc = derive_budgets(
            ds, args.thresh_cn, args.thresh_1hop, args.thresh_non1hop,
            include_combined=True,
        )[3]
        if not args.non_verbose:
            print(f"[budgets] measured combined budget: {bc} "
                  f"(p99.9 of total per-link count)", flush=True)
    elif bc is not None:
        bc = int(bc)
    return LPFormerConfig(
        dim=args.dim,
        num_heads=args.num_heads,
        gnn_layers=args.gnn_layers,
        trans_layers=args.tlayers,
        pred_layers=args.pred_layers,
        thresh_cn=args.thresh_cn,
        thresh_1hop=args.thresh_1hop,
        thresh_non1hop=args.thresh_non1hop,
        residual=args.residual,
        layer_norm=not args.no_layer_norm,
        relu=not args.no_relu,
        dropout=args.dropout,
        gnn_drop=args.gnn_drop,
        att_drop=args.att_drop,
        feat_drop=args.feat_drop,
        pred_drop=args.pred_drop,
        budget_cn=budgets[0],
        budget_onehop=budgets[1],
        budget_non1hop=budgets[2],
        budget_combined=bc,
        matmul_dtype=args.matmul_dtype,
        use_pallas_attention=args.pallas_attention,
    )


def apply_config(parser: argparse.ArgumentParser, argv):
    """Two-phase parse: read --config first, load its JSON as parser
    defaults (explicit CLI flags still win), then parse fully. A bare
    name resolves under the repo's configs/ directory."""
    pre, _ = parser.parse_known_args(argv)
    if pre.config is None:
        return parser.parse_args(argv)
    import json

    path = pre.config
    if not os.path.exists(path):
        cand = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "configs", path + ".json",
        )
        if os.path.exists(cand):
            path = cand
        else:
            raise FileNotFoundError(
                f"--config {pre.config!r}: no such file, and no "
                f"configs/{pre.config}.json"
            )
    with open(path) as f:
        cfg = json.load(f)
    known = {a.dest for a in parser._actions}
    unknown = set(cfg) - known
    if unknown:
        raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
    parser.set_defaults(**cfg)
    return parser.parse_args(argv)


def _cli_rank(rank, argv):
    return main(argv)


def _local_ranks(args, device) -> int:
    """The ranks of a --mesh run without the multi-process flags; on CUDA
    one visible GPU each, or this raises."""
    import torch

    from lpformer_tpu_torch.train.trainer import parse_mesh

    gpus = 0 if device == "cpu" else torch.cuda.device_count()
    if args.mesh == "auto":
        return max(gpus, 1)
    d, g = parse_mesh(args.mesh)
    if device != "cpu" and gpus < d * g:
        raise RuntimeError(f"--mesh {args.mesh} needs {d * g} GPUs, one per "
                           f"rank; {gpus} visible")
    return d * g


def main(argv=None):
    args = apply_config(build_parser(), argv)
    device = resolve_platform(args.platform)
    if args.mesh and args.grad_accum > 1:
        raise ValueError("--grad-accum is not supported with --mesh")

    from lpformer_tpu_torch.parallel import distributed

    # bring-up precedes any device work
    joined = distributed.initialize(
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, auto=args.distributed == "auto",
        device=device)
    if args.mesh and not joined:
        n = _local_ranks(args, device)
        if n > 1:
            # one command on one host, as the JAX CLI: rank 0's result
            return distributed.spawn_local(_cli_rank, n, (argv,),
                                           device=device, timeout_s=None)[0]
        distributed.init_single(device)
    if not distributed.is_coordinator():
        args.non_verbose = True

    from lpformer_tpu_torch.utils.seed import init_seed

    # reference init_seed (utils.py:11-17); unset, the device is CUDA
    init_seed(args.seed, device or "cuda")

    t0 = time.perf_counter()
    # on a mesh the whole dataset stays on the host: each rank puts only
    # its shards on its device
    ds = load_dataset(args, "cpu" if args.mesh else device)
    if not args.non_verbose:
        print(f"[data] {args.data_name}: {ds.num_nodes} nodes, "
              f"{len(ds.train_pos)} train links, read and built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.metric is None:  # explicit --metric (or config) wins
        args.metric = default_metric(args)
    cfg = build_config(args, ds)
    if args.checkpoint is not None:
        return eval_checkpoint(args, cfg, ds)

    from lpformer_tpu_torch.train.trainer import TrainArgs, train_data

    targs = TrainArgs(
        epochs=args.epochs,
        lr=args.lr,
        decay=args.decay,
        l2=args.l2,
        batch_size=args.batch_size,
        test_batch_size=args.test_batch_size,
        num_negative=args.num_negative,
        eval_steps=args.eval_steps,
        kill_cnt=args.kill_cnt,
        runs=args.runs,
        seed=args.seed,
        metric=args.metric,
        heart=args.heart,
        mask_input=args.mask_input,
        save_as=args.save_as,
        checkpoint_dir=args.checkpoint_dir,
        verbose=not args.non_verbose,
        data_name=args.data_name,
        double_propagate=(True if args.double_propagate
                          else False if args.single_propagate else None),
        resume=args.resume,
        save_every=args.save_every,
        grad_accum=args.grad_accum,
        mesh=args.mesh,
        context_parallel=args.context_parallel,
        steps_per_call=args.steps_per_call,
    )
    result = train_data(targs, cfg, ds)
    if args.dump_att and args.save_as:
        _dump_attention(args, cfg, ds)
    return result


def _dump_attention(args, cfg, ds):
    """--dump-att: the best checkpoint's attention weights over the first
    ``--test-batch-size`` test positives, on the test graph (reference
    run.py:193, layers.py:69-75), to ``attention_weights.npz`` in the
    working directory: edges [B, 2], ids, valid and alpha [B, C] (alpha
    averaged over the heads)."""
    from lpformer_tpu_torch.evalx.analysis import attention_weights
    from lpformer_tpu_torch.train.optim import tree_map
    from lpformer_tpu_torch.utils import checkpoint as ckpt

    path = os.path.join(
        args.checkpoint_dir, args.data_name,
        args.save_as + ("_seed-1" if args.runs > 1 else "") + ".ckpt",
    )
    state = ckpt.load_checkpoint(path)
    if state is None:
        print(f"--dump-att: no checkpoint at {path}")
        return
    dev = ds.graph.x.device
    params = tree_map(lambda t: t.to(dev), state["params"])
    edges = np.asarray(ds.test_pos)[: args.test_batch_size]
    ids, valid, alpha = attention_weights(params, cfg, ds, edges,
                                          test_set=True)
    np.savez_compressed(
        "attention_weights.npz", edges=edges, ids=ids, valid=valid,
        alpha=alpha,
    )
    print(f"--dump-att: wrote attention_weights.npz for {len(edges)} edges")


def eval_checkpoint(args, cfg, ds):
    """Checkpoint-only evaluation (reference run.py:17-87) of checkpoints
    that either package wrote, on the dataset's device; with ``--mesh``
    (and ``--context-parallel``) through the mesh's sharded scorer, so a
    checkpoint evaluates on graphs no one card holds."""
    from lpformer_tpu_torch.parallel import distributed
    from lpformer_tpu_torch.train.optim import tree_map
    from lpformer_tpu_torch.train.trainer import (
        TrainArgs, parse_mesh, run_eval,
    )
    from lpformer_tpu_torch.utils import checkpoint as ckpt

    targs = TrainArgs(
        test_batch_size=args.test_batch_size, metric=args.metric,
        heart=args.heart, data_name=args.data_name,
        checkpoint_dir=args.checkpoint_dir,
    )
    dev = ds.graph.x.device
    eval_ctx = None
    if args.mesh:
        from lpformer_tpu_torch.parallel import make_mesh
        from lpformer_tpu_torch.parallel.eval import ShardedEvalContext

        d, g = parse_mesh(args.mesh)
        link_dev = d if args.context_parallel else d * g
        if args.test_batch_size % link_dev:
            raise ValueError(
                f"test_batch_size {args.test_batch_size} must divide over "
                f"{link_dev} link-sharding devices")
        dev = distributed.rank_device(dev)
        eval_ctx = ShardedEvalContext(
            cfg, make_mesh(data=d, graph=g, device=dev), ds,
            context_parallel=args.context_parallel)
    say = print if distributed.is_coordinator() else (lambda *a: None)
    results = []
    for run in range(1, args.runs + 1):
        suffix = f"_seed-{run}" if args.runs > 1 else ""
        path = os.path.join(
            args.checkpoint_dir, args.data_name,
            args.checkpoint + suffix + ".ckpt",
        )
        state = ckpt.load_checkpoint(path)
        if state is None:
            raise FileNotFoundError(path)
        params = tree_map(lambda t: t.to(dev), state["params"])
        r = run_eval(params, cfg, ds, targs, sharded=eval_ctx)
        say(f">>> Seed={run}")
        for k, v in r.items():
            say(f"  {k} = {v}")
        results.append(r[args.metric][-1])
    say("\nMean Performance:")
    say(f"    {args.metric} -->", float(np.mean(results)))
    return results


if __name__ == "__main__":
    main()
