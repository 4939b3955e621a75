"""Where the eval time goes on the card, from torch.profiler traces.

    python -m lpformer_tpu_torch.profile_eval [--classic | --citation2 |
                                              --ppa]

On the combined context table (presets.COLLAB_LIKE_CONFIG), or with
``--classic`` on the classic per-class table
(presets.COLLAB_LIKE_CLASSIC_CONFIG), or with ``--citation2`` on the
citation2-like preset (presets.CITATION2_LIKE_CONFIG, the combined table of
96 at dim 64, its inputs drawn with ``measure.citation2_link_counts``, the
sweep test_citation2's: 1000 negative targets per positive, batches of
32768, ``measure.citation2_like_dataset``), or with ``--ppa`` on the
ppa-like preset (presets.PPA_LIKE_CONFIG: 576,000 nodes on the BlockedBELL,
the combined table of 96 at dim 64, residual GCN; the sweep
test_standard's with Hits@100 over 1,000,000 uniform negative pairs a
split, batches of 32768, ``measure.ppa_like_dataset``; its wrapper inputs
are the ones the sweep's first batch of negatives really extracts, recorded
with ``measure.recording_kernel_inputs``, and f32 casts of them):

1. The table's fused PE+attention forward wrapper alone on chip_smoke.py's
   main-path inputs, bf16 and f32: its device time per call and every
   device kernel it launches (the slot compaction's ops and the three
   forward kernels) from the profiler, beside the CUDA-event time per call
   of 20 back-to-back wrapper calls and the work's bound.
2. The preset's eval sweep (presets.py, random weights): after one
   warm-up sweep, a traced test_standard sweep (propagate once + every
   score batch): wall time, device busy time (the CUDA kernels' self
   time), the device idle share, and the kernels that take the most device
   time. The profiler's own host overhead is inside the wall time, so the
   idle share is an upper bound.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse

import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.evalx import harness
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.ops import pe_attention as pa
from lpformer_tpu_torch.ops import pe_attention_mixed as pam
from lpformer_tpu_torch.presets import (
    CITATION2_LIKE_BATCH, CITATION2_LIKE_CONFIG, COLLAB_LIKE_BATCH,
    COLLAB_LIKE_CLASSIC_CONFIG, COLLAB_LIKE_CONFIG, COLLAB_LIKE_DATA,
    PPA_LIKE_BATCH, PPA_LIKE_CONFIG,
)
from lpformer_tpu_torch.utils import measure
from lpformer_tpu_torch.utils.measure import (
    card_line, print_wrapper_trace, time_ms, trace_device,
)


def wrapper_report(op, a, bound_ms, card) -> None:
    """The forward wrapper ``op`` on the inputs ``a``: CUDA-event time per
    back-to-back call beside the work's bound, then its traced kernels."""
    dtype = str(a["keys"].dtype)[6:]

    def call():
        return op(**a)

    bound, by, nv = bound_ms(a)
    print(f"forward wrapper {dtype}: {time_ms(call, 10, per=20):.4f} ms per "
          f"back-to-back call (events), bound {bound:.5f} ms ({by}); {nv} "
          f"valid slots [{card}]")
    print_wrapper_trace(f"forward wrapper {dtype}", call, card)


def ppa_sweep_inputs(params, cfg, ds, batch):
    """The combined op's inputs of the sweep's first batch of negatives,
    as extracted (``recording_kernel_inputs``), in the config's dtype and
    cast to f32."""
    with torch.no_grad():
        X = lt.propagate(params, cfg, ds.graph)
        t = torch.as_tensor(ds.valid_neg[:batch]).to(X.device)
        with measure.recording_kernel_inputs() as rec:
            harness.make_score_fn(cfg)(params, ds.graph, X, t[:, 0], t[:, 1])
    a = rec["fwd"][0]
    table, ids = pam.key_parts(a["keys"])
    return [a, dict(a, keys=pam.join_keys(table.float(), ids),
                    w2f=a["w2f"].float())]


def main(classic: bool = False, citation2: bool = False, ppa: bool = False,
         top: int = 12) -> None:
    dev = resolve_device()
    card = card_line()
    if classic:
        op, inputs, bound_ms = (pa.fused_pe_link_attention,
                                measure.classic_kernel_inputs,
                                measure.classic_bound_ms)
    else:
        op, inputs, bound_ms = (pam.fused_pe_link_attention_mixed,
                                measure.kernel_inputs, measure.kernel_bound_ms)
    if ppa:
        cfg, batch = PPA_LIKE_CONFIG, PPA_LIKE_BATCH
        ds = measure.ppa_like_dataset(dev)
    elif citation2:
        cfg, batch = CITATION2_LIKE_CONFIG, CITATION2_LIKE_BATCH
        ds = measure.citation2_like_dataset(dev)
    else:
        cfg = COLLAB_LIKE_CLASSIC_CONFIG if classic else COLLAB_LIKE_CONFIG
        batch = COLLAB_LIKE_BATCH
        ds = synthetic_dataset(**COLLAB_LIKE_DATA, device=dev)
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    if ppa:
        runs = ppa_sweep_inputs(params, cfg, ds, batch)
    else:
        shape = {} if not citation2 else dict(
            b=batch, c=cfg.budget_combined, o=cfg.dim, dh=cfg.dim,
            counts=measure.citation2_link_counts)
        runs = [inputs(dev, dtype, **shape)
                for dtype in (torch.bfloat16, torch.float32)]
    for a in runs:
        wrapper_report(op, a, bound_ms, card)
    del runs, a

    if citation2:
        name = "test_citation2"
        links = (len(ds.valid_pos) + len(ds.test_pos) + ds.valid_neg.size
                 + ds.test_neg.size)

        def sweep():
            return harness.test_citation2(params, cfg, ds, batch_size=batch)
    else:
        name = "test_standard"
        links = sum(len(x) for x in (ds.train_pos_val, ds.valid_pos,
                                     ds.test_pos, ds.valid_neg, ds.test_neg))

        def sweep():
            return harness.test_standard(params, cfg, ds, batch_size=batch)
    sweep()
    wall_ms, busy_ms, rows = trace_device(sweep, top)
    print(f"{name} sweep of {links} links (traced): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; {links / wall_ms * 1e3:.0f} links/s "
          f"[{card}]")
    for ms, count, name in rows:
        print(f"  {ms:9.3f} ms  {count:5d}x  {name[:100]}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--classic", action="store_true",
                       help="the classic per-class context table")
    which.add_argument("--citation2", action="store_true",
                       help="the citation2-like preset and its sweep")
    which.add_argument("--ppa", action="store_true",
                       help="the ppa-like preset and its Hits@100 sweep")
    args = ap.parse_args()
    main(args.classic, args.citation2, args.ppa)
