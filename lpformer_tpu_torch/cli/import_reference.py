"""Convert a trained reference LPFormer ``.pt`` checkpoint into the
checkpoint format both packages read, for ``--checkpoint`` evaluation
(counterpart of ``scripts/import_reference_checkpoint.py``).

The reference saves ``{"model": state_dict, "score_func": state_dict,
"optimizer": ...}`` per seed (reference: src/util/utils.py:21-35, file
name ``checkpoints/{data}/{name}[_seed-k].pt``). This maps the tensors
through ``utils/interop.py:import_reference_state`` on the CPU and writes
``checkpoints/{data}/{out}[_seed-k].ckpt`` with
``utils/checkpoint.py:save_checkpoint``, so

    python -m lpformer_tpu_torch.cli.run --data_name ogbl-collab \\
        --checkpoint <out> --runs K ...

evaluates the pretrained weights.

Usage:
  python -m lpformer_tpu_torch.cli.import_reference IN.pt \\
      --data ogbl-collab --out imported [--seeds K]
With --seeds K, reads IN_seed-1.pt .. IN_seed-K.pt (IN given without
the .pt extension in that case, the reference's multi-seed naming).
"""
from __future__ import annotations

import argparse
import os

import torch

from lpformer_tpu_torch.train.optim import tree_leaves
from lpformer_tpu_torch.utils.checkpoint import save_checkpoint
from lpformer_tpu_torch.utils.interop import import_reference_state


def convert_one(pt_path: str, ckpt_path: str) -> None:
    state = torch.load(pt_path, map_location="cpu")
    params = import_reference_state(
        {"model": state["model"], "score_func": state["score_func"]},
        device="cpu",
    )
    n = sum(x.numel() for x in tree_leaves(params))
    save_checkpoint(ckpt_path, {"params": params, "step": 0, "epoch": 0})
    print(f"{pt_path} -> {ckpt_path} ({n:,} params)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("pt", help=".pt file (or basename when --seeds > 1)")
    ap.add_argument("--data", required=True, help="dataset name (output dir)")
    ap.add_argument("--out", default="imported",
                    help="output checkpoint name for --checkpoint")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--outdir", default="checkpoints")
    args = ap.parse_args(argv)

    outdir = os.path.join(args.outdir, args.data)
    if args.seeds > 1:
        for k in range(1, args.seeds + 1):
            convert_one(f"{args.pt}_seed-{k}.pt",
                        os.path.join(outdir, f"{args.out}_seed-{k}.ckpt"))
    else:
        convert_one(args.pt, os.path.join(outdir, f"{args.out}.ckpt"))


if __name__ == "__main__":
    main()
