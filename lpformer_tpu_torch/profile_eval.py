"""Where the eval time goes on the card, from torch.profiler traces.

    python -m lpformer_tpu_torch.profile_eval [--classic]

On the combined context table (presets.COLLAB_LIKE_CONFIG), or with
``--classic`` on the classic per-class table
(presets.COLLAB_LIKE_CLASSIC_CONFIG):

1. The table's fused PE+attention forward wrapper alone on chip_smoke.py's
   main-path inputs, bf16 and f32: its device time per call and every
   device kernel it launches (the slot compaction's ops and the three
   forward kernels) from the profiler, beside the CUDA-event time per call
   of 20 back-to-back wrapper calls and the work's bound.
2. The collab-like eval sweep (presets.py, random weights): after one
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
    COLLAB_LIKE_BATCH, COLLAB_LIKE_CLASSIC_CONFIG, COLLAB_LIKE_CONFIG,
    COLLAB_LIKE_DATA,
)
from lpformer_tpu_torch.utils import measure
from lpformer_tpu_torch.utils.measure import (
    card_line, print_wrapper_trace, time_ms, trace_device,
)


def main(classic: bool = False, top: int = 12) -> None:
    dev = resolve_device()
    card = card_line()
    if classic:
        op, inputs, bound_ms = (pa.fused_pe_link_attention,
                                measure.classic_kernel_inputs,
                                measure.classic_bound_ms)
    else:
        op, inputs, bound_ms = (pam.fused_pe_link_attention_mixed,
                                measure.kernel_inputs, measure.kernel_bound_ms)
    for dtype in (torch.bfloat16, torch.float32):
        a = inputs(dev, dtype)

        def call():
            return op(**a)

        bound, by, nv = bound_ms(a)
        print(f"forward wrapper {str(dtype)[6:]}: "
              f"{time_ms(call, 10, per=20):.4f} ms per back-to-back call "
              f"(events), bound {bound:.5f} ms ({by}); {nv} valid slots "
              f"[{card}]")
        print_wrapper_trace(f"forward wrapper {str(dtype)[6:]}", call, card)

    cfg = COLLAB_LIKE_CLASSIC_CONFIG if classic else COLLAB_LIKE_CONFIG
    ds = synthetic_dataset(**COLLAB_LIKE_DATA, device=dev)
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=COLLAB_LIKE_DATA["feat_dim"], device=dev)
    harness.test_standard(params, cfg, ds, batch_size=COLLAB_LIKE_BATCH)
    wall_ms, busy_ms, rows = trace_device(
        lambda: harness.test_standard(params, cfg, ds,
                                      batch_size=COLLAB_LIKE_BATCH), top)
    print(f"test_standard sweep (traced): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f} [{card}]")
    for ms, count, name in rows:
        print(f"  {ms:9.3f} ms  {count:5d}x  {name[:100]}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--classic", action="store_true",
                    help="the classic per-class context table")
    main(ap.parse_args().classic)
