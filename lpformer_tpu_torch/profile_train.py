"""Where a training step's time goes on the card, from a torch.profiler
trace.

    python -m lpformer_tpu_torch.profile_train [--classic | --ddi |
                                               --citation2 | --ppa |
                                               --pubmed] [steps]

Builds the collab-like dataset (presets.py), with the combined context
table (COLLAB_LIKE_CONFIG) or with ``--classic`` the classic per-class
table (COLLAB_LIKE_CLASSIC_CONFIG), or with ``--ddi`` the ddi-like dataset
and preset (DDI_LIKE_CONFIG: dim 256, combined table), or with
``--citation2`` the citation2-like ones (CITATION2_LIKE_CONFIG: 1M nodes on
the BlockedBELL, dim 64, batch 32768), or with ``--ppa`` the ppa-like ones
(PPA_LIKE_CONFIG: 576,000 nodes on the BlockedBELL of kb 5, dim 64, batch
32768, the residual GCN), or with ``--pubmed`` the
pubmed-like ones (PUBMED_LIKE_CONFIG: f32, the classic table of C = 224,
batch 1024, ``mask_input``: two propagations a step, the positive half's
re-weighted), takes two warm-up training steps of the preset's batch with
the preset's dropouts, then traces
``steps``
(default 5) more: wall time per step, device busy time per step (the CUDA
kernels' self time), the device idle share, and the kernels that take the
most device time, with their launch counts. The profiler's own host
overhead is inside the wall time, so the idle share is an upper bound.
With ``--classic`` it then traces the classic table's forward and
backward wrappers alone, at the main-path shape and at the ddi-like
classic blocks, and with ``--ddi`` the combined table's, at the main-path
shape and at O = dh = 256 with the ddi-like density; each lists every
kernel it launches.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.presets import (
    CITATION2_LIKE_BATCH, CITATION2_LIKE_CONFIG, CITATION2_LIKE_DATA,
    COLLAB_LIKE_BATCH, COLLAB_LIKE_CLASSIC_CONFIG, COLLAB_LIKE_CONFIG,
    COLLAB_LIKE_DATA, DDI_LIKE_BATCH, DDI_LIKE_CONFIG, DDI_LIKE_DATA,
    PPA_LIKE_BATCH, PPA_LIKE_CONFIG, PPA_LIKE_DATA, PUBMED_LIKE_BATCH,
    PUBMED_LIKE_CONFIG, PUBMED_LIKE_DATA, PUBMED_LIKE_L2, PUBMED_LIKE_LR,
)
from lpformer_tpu_torch.train import optim, step as step_mod
from lpformer_tpu_torch.utils.measure import (
    card_line, print_wrapper_trace, trace_device,
)


def main(steps: int = 5, classic: bool = False, ddi: bool = False,
         citation2: bool = False, pubmed: bool = False, ppa: bool = False,
         top: int = 15) -> None:
    dev = resolve_device()
    card = card_line()
    lr, l2 = 1e-3, 0.0
    if pubmed:
        cfg, data, batch = (PUBMED_LIKE_CONFIG, PUBMED_LIKE_DATA,
                            PUBMED_LIKE_BATCH)
        lr, l2 = PUBMED_LIKE_LR, PUBMED_LIKE_L2
    elif ddi:
        cfg, data, batch = DDI_LIKE_CONFIG, DDI_LIKE_DATA, DDI_LIKE_BATCH
    elif citation2:
        cfg, data, batch = (CITATION2_LIKE_CONFIG, CITATION2_LIKE_DATA,
                            CITATION2_LIKE_BATCH)
    elif ppa:
        cfg, data, batch = PPA_LIKE_CONFIG, PPA_LIKE_DATA, PPA_LIKE_BATCH
    else:
        cfg = COLLAB_LIKE_CLASSIC_CONFIG if classic else COLLAB_LIKE_CONFIG
        data, batch = COLLAB_LIKE_DATA, COLLAB_LIKE_BATCH
    ds = synthetic_dataset(**data, device=dev)
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=data["feat_dim"], device=dev)
    for p in optim.tree_leaves(params):
        p.requires_grad_(True)
    opt = optim.make_optimizer(
        lr, l2, steps_per_epoch=-(-len(ds.train_pos) // batch))
    state = step_mod.TrainState(params, opt.init(params), 0)
    train_step = step_mod.make_train_step(cfg, opt, mask_input=pubmed)
    mult = ds.mask_mult_device
    bin_w = (ds.graph.edge_w > 0).float()
    gen = torch.Generator(device=dev).manual_seed(0)
    order = np.random.default_rng(0).permutation(len(ds.train_pos))
    links = torch.as_tensor(ds.train_pos[order]).to(dev)
    w = torch.ones(batch, device=dev)

    def run(lo, n):
        nonlocal state
        for i in range(lo, lo + n):
            b = links[i * batch:(i + 1) * batch]
            state, _ = train_step(state, ds.graph, mult, bin_w, b[:, 0],
                                  b[:, 1], w, gen)

    run(0, 2)
    wall_ms, busy_ms, rows = trace_device(lambda: run(2, steps), top)
    print(f"{steps} training steps of {batch} (traced): wall "
          f"{wall_ms / steps:.3f} ms/step, device busy {busy_ms / steps:.3f} "
          f"ms/step, idle share {1 - busy_ms / wall_ms:.3f} [{card}]")
    for ms, count, name in rows:
        print(f"  {ms / steps:9.3f} ms/step  {count / steps:6.1f}x/step  "
              f"{name[:100]}")
    if classic or ddi:
        trace_wrappers(dev, card, classic)


def trace_wrappers(dev, card, classic: bool, calls: int = 10) -> None:
    """A table's forward and backward wrappers alone, bf16, each shape
    traced over ``calls`` calls: every device kernel each launches (the
    slot compaction's ops, the zeroed outputs, the tile kernels), per call.
    The classic table at the main-path shape
    (``measure.classic_kernel_inputs``) and at the ddi-like classic blocks
    (O = dh = 256); the combined table at the main-path shape
    (``measure.kernel_inputs``) and at O = dh = 256 with the ddi-like
    density (``measure.ddi_link_counts``)."""
    from lpformer_tpu_torch.ops import pe_attention as pa
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam
    from lpformer_tpu_torch.presets import DDI_LIKE_CLASSIC_WIDTHS
    from lpformer_tpu_torch.utils.measure import (
        bwd_inputs, classic_kernel_inputs, ddi_link_counts, kernel_inputs,
    )

    if classic:
        table, fwd, bwd, inputs = ("classic", pa.fused_pe_link_attention,
                                   pa.fused_pe_link_attention_bwd,
                                   classic_kernel_inputs)
        wide = ("ddi-like classic", dict(widths=DDI_LIKE_CLASSIC_WIDTHS,
                                         o=256, dh=256))
    else:
        table, fwd, bwd, inputs = ("combined",
                                   pam.fused_pe_link_attention_mixed,
                                   pam.fused_pe_link_attention_mixed_bwd,
                                   kernel_inputs)
        wide = ("ddi-like density", dict(o=256, dh=256,
                                         counts=ddi_link_counts))
    for label, kw in (("main", {}), wide):
        a = inputs(dev, torch.bfloat16, **kw)
        nv = int(a["valid"].sum())
        print_wrapper_trace(f"{table} forward wrapper, {label} shape, {nv} "
                            f"valid slots", lambda: fwd(**a), card, calls)
        b = bwd_inputs(a)
        print_wrapper_trace(f"{table} backward wrapper, {label} shape, {nv} "
                            f"valid slots", lambda: bwd(**b), card, calls)
        del a, b


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", type=int, nargs="?", default=5)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--classic", action="store_true",
                       help="the classic per-class context table")
    which.add_argument("--ddi", action="store_true",
                       help="the ddi-like preset (dim 256)")
    which.add_argument("--citation2", action="store_true",
                       help="the citation2-like preset (1M nodes, dim 64)")
    which.add_argument("--ppa", action="store_true",
                       help="the ppa-like preset (576k nodes, residual GCN)")
    which.add_argument("--pubmed", action="store_true",
                       help="the pubmed-like preset (mask_input, f32)")
    args = ap.parse_args()
    main(args.steps, args.classic, args.ddi, args.citation2, args.pubmed,
         args.ppa)
