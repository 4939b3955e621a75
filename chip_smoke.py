"""Smoke run of the PyTorch/CUDA port (lpformer_tpu_torch) on one H100.

    python3 chip_smoke.py [--collab-scale S] [--deterministic-ab]

With no arguments phase 12 reads the collab npz at REHEARSAL_SCALE;
``--collab-scale 1.0`` reads it at ogbl-collab's full size, and
``--deterministic-ab`` adds phase 12's A/B of torch's deterministic
algorithms.

Phases, each printing its own lines:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the eight CUDA libraries (nvcc, sm_90a: the fused
     PE+attention forward and backward of each context-table layout, the
     scatter-add, the per-link attention forward and backward, the fused
     lookup) and the PPR push library (g++) from the checkout's sources,
     all at once;
  3. kernels: each kernel against its plain torch version on the card at
     its main-path shapes, with CUDA-event times, the work's bound and a
     yardstick (the PE+attention and per-link attention wrappers' checked
     calls, forward and backward, under
     ``torch.cuda.set_sync_debug_mode("error")``, so a
     host synchronisation fails them): the combined table's pair at
     B=4096, C=128, O=dh=128, K=3
     (bf16 and f32), then at the ddi-like widths O=dh=256 and at O=256,
     dh=128 (bf16), these with the collab-like draw's ~10 valid slots a
     link, and at O=dh=256 with the ddi-like preset's ~43 (bf16,
     measure.ddi_link_counts); the classic table's pair at C=320 (blocks
     64 | 128 | 128), O=dh=128 (bf16 and f32), then at the ddi-like
     classic blocks 128 | 320 | 320, O=dh=256 (bf16); the scatter over
     [4096, 128] rows into 50,001, with its traced device time (zeroing
     and kernel apart), beside ``index_add_`` over all rows and over the
     compacted live rows; the per-link attention pair at the
     bench's A/B shape (B=4096, C=128, Dk=256, O=128, 80% valid) in f32 and
     bf16 (phase 7 times their yardstick, the A/B's torch composition);
     and, on the collab-like dataset, the fused lookup at each of its
     context-extraction shapes, bit for bit, with its traced device time,
     beside the searchsorted route;
then, for each table layout of the collab-like preset (presets.py: the
combined table of budget 128, then the classic per-class table of budgets
64 / 128 / 128), and for the ddi-like preset (dim 256, combined table):
  4. eval path: the preset's synthetic dataset, random weights from a fixed
     seed, propagate once and score the eval sets in batches of 4096
     through test_standard; the layout's forward kernel launch count must
     equal the number of score batches, every eval link's score must be
     finite, and one batch's scores must match the port's plain path;
  5. train path: one step with dropout off and fixed negatives, whose loss
     and every gradient leaf through the kernels must match the plain
     versions on the card; then train_loop for one epoch of batches of
     4096 with the default dropouts and one test_standard at its end:
     every loss finite, metrics in [0, 1], and the launch counts of all
     eight kernels equal to the path's calls (the other kernels at 0); then
     the median step time, split into forward, backward and optimizer, and
     the step's peak memory;
and, on the collab-like combined table with LPFORMER_FUSED_LOOKUP=1:
  6. fused lookup route: the eval-mode and train-mode context tables of a
     batch identical to the default route's; a test_standard sweep with
     metrics identical to the default route's, and one training step with
     the same loss; the fused lookup's launches equal to the route's calls;
and the per-link attention op's own path:
  7. the bench's attention A/B (forward, and forward + backward) through
     fused_link_attention in f32 and bf16, with launches counted;
  8. HeaRT: the collab-like dataset with 100 negatives per eval positive,
     run_eval -> test_standard(heart=True) on the combined table: the
     per-positive MRR in [0, 1], the forward kernel's launches equal to
     the score batches;
  9. the citation2-like preset (presets.py: 1,000,000 nodes, 5,000,000
     train edges, dim 64, batch 32768, the combined table of 96; 1000
     negative targets per eval positive, measure.citation2_like_dataset):
     the host build, whose propagation layout must be the BlockedBELL of
     kb = 8 (slots and the bundle's device memory printed); one GCN
     layer's SpMM at [1M, 64], f32 and bf16 gather, through spmm_bbell
     against a single BucketedELL and a static BlockedCOO of the same
     graph (errors and times: an A/B, the layout rule stays the JAX
     package's); the mask_input arm: a batch of 32768 train links masked
     out of the propagation weights (mask_edge_weights, gcn_norm_device),
     the BlockedCOO re-weighted through its edge ids against the
     BucketedELL re-weighted through its slots' edge ids; rows 1-2 (B=32768, C=96, O=dh=64, K=3: bf16 drawn with
     measure.citation2_link_counts, then bf16 and f32 with the collab-like
     spread and bf16 with every slot valid) and row 3 (into 1,000,001
     rows, its zeroing apart, beside index_add_) against their plain
     versions; one training step through the kernels against the plain
     path, then 8 steps with the default dropouts (losses finite, rows 1-3
     launched
     once per call, stage times, peak memory); run_eval -> test_citation2
     at batch 32768 (every score finite, MRR in [0, 1], the forward
     kernel's launches equal to the score batches, one batch of the sweep
     against the plain path, propagate ms, links/s);
 10. the pubmed-like preset (presets.py: configs/pubmed-existing.json, f32,
     the classic table of 32 | 96 | 96, batch 1024, mask_input; a
     synthetic graph of Pubmed's size): the BucketedELL with slot edge ids
     and edge_rank; one training step (two propagations, the positive
     half's re-weighted) through the kernels against the plain path;
     train_loop for 2 epochs with steps_per_call 4, grad_accum 2,
     save_every 1 and save_as (losses finite, metrics in [0, 1], rows 3-5
     launched as the path's calls say); a resume from its
     .latest.ckpt for epoch 3 (the state restored bit for bit); stage
     times of the step and peak memory;
 11. on the ddi-like dataset: one step on the classic table (128 | 320 |
     320, O = dh = 256, bf16) where the auto rule turns the pairwise
     block's remat on, against remat off with the dropouts on and the same
     generator seed (row 4 launched once more a forward under remat), and
     a grad_accum=2 step of the combined table against the monolithic one
     (rows 1-3), each pair's ms and peak memory;
then graft_entry.entry()'s forward once (row 4), and the CLI,
``lpformer_tpu_torch.cli.run.main``, in a scratch working directory:
 12. scripts/make_rehearsal_npz.py writes the schema-exact collab npz
     (REHEARSAL_SCALE of ogbl-collab, or --collab-scale); ``--config
     ogbl-collab-existing --runs 1 --epochs 1 --save-as`` reads it (year
     filter, both PPRs at eps 5e-5 and their cache, both bundles),
     measures the budgets and trains one epoch of batches of 24,000 in f32
     on the classic table (rows 3-5): host build, budgets, the remat
     rule, epoch wall and peak memory printed, the loss finite, the
     launches as predicted from the path's calls, both PPR cache files
     present; ``--checkpoint`` then rebuilds from the cache and must
     print the training run's best metrics bit for bit, and score every
     eval link as the training run's eval did within CKPT_SCORE_TOL (row
     4's f32 atomics reorder from run to run); then, on that dataset and
     the CLI's config, rows 4-5 against their plain versions in f32 at
     the path's class widths, O = dh = dim (the forward at the eval batch,
     the backward at the train batch), and one training step through the
     kernels against the plain path; with --deterministic-ab, torch's
     deterministic algorithms on against off (step medians by CUDA
     events, warnings, and the device kernels the flag swaps, from a
     trace of each);
 13. ``--config cora-heart --runs 1 --epochs 1 --eval_steps 1`` on a
     Planetoid + HeaRT fixture at Cora's published sizes: rows 3-5 at
     dh = 256 in f32, the MRR in [0, 1], the launches as predicted; then
     rows 4-5 and one step against their plain versions as in phase 12;
then a "kernels:" summary line and a JSON line of per-kernel numbers (each
kernel's launches from its path's run: rows 1-3 the collab-like combined
train_loop, rows 4-5 the classic one, rows 6-7 phase 7, row 8 phase 6),
the card line again, and as the last line {"ok": true, "device": {...}}.
Any failure exits nonzero before that line. Nothing here imports JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import io
import json
import math
import os
import re
import statistics
import argparse
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lpformer_tpu_torch.utils import measure
from lpformer_tpu_torch.utils.measure import (
    bwd_inputs, card_line, in_link_chunks, scatter_inputs, time_ms,
)

# Kernel vs plain on the card, (max abs, mean abs) error on out and m and
# max relative error on l. f32: only the summation order differs. bf16:
# both round the hidden activation to bf16, but a last-bit difference in
# its f32 value flips a rounding (2^-8 relative; one flip moves an output
# by up to ~5e-3), so the max bound allows a few flips (a logic error is
# O(0.1)) and the mean bound catches any systematic error.
TOL = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (1e-2, 1e-4)}
# scores through the kernel vs through the plain version, both bf16
SCORE_TOL = 5e-3
# Backward kernel vs plain, per output: (max |err| / max |plain|, mean |err|
# / mean |plain|). f32: summation order only (per-block f32 atomics). bf16:
# both round h and dxj to bf16 at the same points, but a last-bit
# difference in an f32 value just before a rounding flips it (2^-8
# relative, e.g. one dkeys element or one dxjc term of a dw2 sum), so the
# max bound allows such flips and the mean bound catches a systematic
# error; a logic error is O(1) in either.
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-3)}
# One training step through the kernels vs through the plain versions, both
# bf16: |loss difference| and, per gradient leaf, ||kernel - plain|| /
# ||plain|| (the bf16 rounding flips above, carried through the model's
# backward; a wrong kernel output is O(1)). Each PE+attention kernel pair
# takes xj, s and alpha from one shared prologue, so its backward's
# softmax gradient cancels against its forward's out as the plain pair's
# does: tests/test_torch_step_pairs.py holds the leaf this moves most,
# att_layers/0/lin_l/w (the weight that makes q), to 5e-3 at the ddi-like
# preset.
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-3, 2e-2
# The same in f32 (the pubmed-like step): only the order of the f32 sums
# differs, so BWD_TOL's f32 max bound holds for the loss's |difference|
# and for every leaf's relative L2 error.
STEP_F32_LOSS_TOL, STEP_F32_GRAD_TOL = 1e-4, 1e-4
# grad_accum 2 against 1 in f32 (the ddi-like combined step), per leaf:
# the micro-batches' GEMMs take half the rows, and cuBLAS rounds a row of
# an [M/2, K] product otherwise than the same row of the [M, K] one (the
# phase logs by how much). The leaves whose gradient cancels across a
# link's slots (att_layers/0/att, lin_l: |g| ~1e-6 against 1e-2 to 1
# elsewhere) carry that rounding at ~6e-4 through the plain versions as
# through the kernels (PERF.md §6); a wrong denominator or a lost
# micro-batch moves every leaf by O(1e-1).
STEP_F32_ACCUM_GRAD_TOL = 2e-3
# Row 5 at a CLI path's shapes in f32 (the collab CLI's backward sums over
# 525,864 valid slots). Its weight grads are sums over every valid slot of
# the batch that cancel, and two rounding-level effects move them past
# BWD_TOL relative to |sum|: the kernel's order of f32 additions (a
# thread's rows, a block's tiles, then one atomic per block and element)
# and the ReLU slopes that flip where their inputs lie within rounding of
# 0 (``python -m lpformer_tpu_torch.profile_kernels --cli-widths`` measures
# both against witnesses: at the collab CLI's shape the kernel is 3.0e-5
# to 3.2e-5 of mean |sum| from the f64 sums, the plain version's tree sums
# 3.1e-7 to 3.4e-7). So each weight-grad element is held to its sum in
# f64 relative to the sum of its terms' magnitudes, which bounds any order
# of f32 additions: a chain of n errs by at most n 2^-24 of it, and the
# dw2 kernel's chains there are ~5,000 long (88 blocks a class on 132 SMs,
# each summing its ~2,500 slots' two directions, then one atomic each),
# so the max over elements is held to 1e-3 (chains up to 16,777), and the
# mean |err| over the mean magnitude to 1e-5, which a backward that loses
# 0.1% of the valid slots exceeds 20-fold (tests/test_torch_pe_attention.py,
# at B 2048 on the CPU). dkeys holds BWD_TOL with its
# elements at the leaky ReLU's kink held to an f64 witness
# (measure.kink_exempt); dq and datt hold BWD_TOL.
SUM_TOL, SUM_TOL_MEAN = 1e-3, 1e-5
# Phase 12's --checkpoint eval scores against the training run's eval of
# the same parameters, max |diff| of the probabilities: row 4 adds each
# link's runs of valid slots into out with f32 atomics
# (csrc/pe_attention_fwd_tiles.cuh), so the order of those additions, and
# the last bits of a score, change from run to run (an ulp is 6e-8 near
# 1); a leaf saved or loaded wrong, or rounded to bf16, moves scores by
# 1e-3 or more.
CKPT_SCORE_TOL = 1e-5
# The citation2-like SpMM layouts against the single BucketedELL, max abs
# error: every arm sums the same products in f32 (after the same bf16
# rounding of x with bf16 gather), in other orders; outputs are O(1)
SPMM_TOL = 1e-4
# The per-link attention op vs the A/B's torch composition, f32 (summation
# order only), on out and the keys' and q's grads: max |err| / max |ref|.
AB_TOL = 1e-4
FUSED_LOOKUP = "LPFORMER_FUSED_LOOKUP"


def log(*a):
    print(*a, flush=True)


def tables():
    """The two context-table layouts, each with its fused op's kernel pair:
    wrappers, plain versions, main-path inputs and bounds, the widths past
    the collab-like shape it is also held at, the name the model calls the
    op by, and the JSON entries' fixed fields."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.ops import pe_attention as pa
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam

    return {
        "combined": dict(
            cfg=presets.COLLAB_LIKE_CONFIG, module=pam,
            op=pam.fused_pe_link_attention_mixed,
            plain=pam.fused_pe_link_attention_mixed_plain,
            bwd=pam.fused_pe_link_attention_mixed_bwd,
            bwd_plain=pam.fused_pe_link_attention_mixed_bwd_plain,
            model_op="fused_pe_link_attention_mixed",
            plain_op=lambda *a: pam.MixedOp.apply(
                pam.fused_pe_link_attention_mixed_plain,
                pam.fused_pe_link_attention_mixed_bwd_plain, *a),
            inputs=measure.kernel_inputs, bound=measure.kernel_bound_ms,
            bwd_bound=measure.bwd_bound_ms,
            wide=[("ddi-like", dict(o=256, dh=256)),
                  ("trans_layers=2 layer 0", dict(o=256, dh=128)),
                  ("ddi-like density", dict(
                      o=256, dh=256, counts=measure.ddi_link_counts))],
            fwd_entry=("fused_pe_link_attention_mixed_fwd",
                       "lpformer_tpu_torch/csrc/pe_attention_mixed_fwd.cu",
                       "lpformer_tpu/ops/pallas/pe_attention_mixed.py:77"),
            bwd_entry=("fused_pe_link_attention_mixed_bwd",
                       "lpformer_tpu_torch/csrc/pe_attention_mixed_bwd.cu",
                       "lpformer_tpu/ops/pallas/pe_attention_mixed.py:250"),
        ),
        "classic": dict(
            cfg=presets.COLLAB_LIKE_CLASSIC_CONFIG, module=pa,
            op=pa.fused_pe_link_attention,
            plain=pa.fused_pe_link_attention_plain,
            bwd=pa.fused_pe_link_attention_bwd,
            bwd_plain=pa.fused_pe_link_attention_bwd_plain,
            model_op="fused_pe_link_attention",
            plain_op=lambda *a, class_widths: pa.BlockedOp.apply(
                pa.fused_pe_link_attention_plain,
                pa.fused_pe_link_attention_bwd_plain, tuple(class_widths),
                *a),
            inputs=measure.classic_kernel_inputs,
            bound=measure.classic_bound_ms,
            bwd_bound=measure.classic_bwd_bound_ms,
            wide=[("ddi-like classic", dict(
                widths=presets.DDI_LIKE_CLASSIC_WIDTHS, o=256, dh=256))],
            fwd_entry=("fused_pe_link_attention_fwd",
                       "lpformer_tpu_torch/csrc/pe_attention_fwd.cu",
                       "lpformer_tpu/ops/pallas/pe_attention.py:81"),
            bwd_entry=("fused_pe_link_attention_bwd",
                       "lpformer_tpu_torch/csrc/pe_attention_bwd.cu",
                       "lpformer_tpu/ops/pallas/pe_attention.py:244"),
        ),
    }


def phase_build():
    """Every library at once, one compiler process each."""
    from lpformer_tpu_torch.graph import ppr
    from lpformer_tpu_torch.ops import attention, lookup
    from lpformer_tpu_torch.ops import pe_attention as pa
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam
    from lpformer_tpu_torch.ops import scatter

    t0 = time.perf_counter()
    with ThreadPoolExecutor(9) as ex:
        futs = [ex.submit(f) for f in (
            pam.build, pam.build_bwd, pa.build, pa.build_bwd, scatter.build,
            attention.build, attention.build_bwd, lookup.build)]
        f_ppr = ex.submit(ppr.build_native)
        built = [f.result() for f in futs]
        ppr_path = f_ppr.result()
    log(f"build: {time.perf_counter() - t0:.1f} s  "
        + "  ".join(p for p, _ in built) + f"  {ppr_path}")
    for _, report in built:
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())


def _entry(fields, max_abs_err, ms, plain_ms, bound, bound_by, lib_ms=None):
    name, source, replaces = fields
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms}


def _runs(t):
    """(dtype, shape label, input keywords) of a layout's kernel checks: the
    main-path shape in bf16 and f32, then each wider shape in bf16."""
    return ([(torch.bfloat16, "main", {}), (torch.float32, "main", {})]
            + [(torch.bfloat16, name, kw) for name, kw in t["wide"]])


def _shape(a):
    b, c, o = a["keys"].shape
    return f"B={b} C={c} O={o} dh={a['w1'].shape[-1]}"


def _fwd_check(layout, t, a, dtype, shape, reps):
    """One forward check of a layout's kernel against its plain version
    on the inputs ``a`` (the wrapper's call under
    ``set_sync_debug_mode("error")``), timed by ``reps`` = (repeats,
    back-to-back calls); logs one line and returns (max abs err, kernel
    ms, plain ms, bound ms, bound_by)."""
    torch.cuda.synchronize()
    # the wrapper and its slot compaction must never wait on the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = t["op"](**a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = in_link_chunks(t["plain"], a, 3)
    errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
    mean_err = float((got[0] - want[0]).abs().mean())
    rel_l = float(((got[2] - want[2]).abs()
                   / want[2].abs().clamp_min(1.0)).max())
    tol, tol_mean = TOL[dtype]
    ok_ = (errs[0] <= tol and errs[1] <= tol and rel_l <= tol
           and mean_err <= tol_mean and bool(torch.isfinite(got[0]).all()))
    del got, want
    ms = time_ms(lambda: t["op"](**a), reps[0], per=reps[1])
    plain_ms = time_ms(lambda: in_link_chunks(t["plain"], a, 3), 3, 1)
    bound, bound_by, nv = t["bound"](a)
    log(f"kernel {layout} {str(dtype)[6:]} {shape} ({_shape(a)}): "
        f"max|out| err {errs[0]:.3e} (mean {mean_err:.3e}), max|m| err "
        f"{errs[1]:.3e}, max rel l err {rel_l:.3e} (tol {tol}, mean "
        f"{tol_mean}); {nv} valid slots of {a['valid'].numel()}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
        f"({bound_by})")
    if not ok_:
        raise AssertionError(f"{layout} kernel disagrees with plain in "
                             f"{dtype} at {shape}")
    return max(errs[0], errs[1]), ms, plain_ms, bound, bound_by


def phase_kernel(dev, layout, t):
    """A layout's forward kernel vs plain at its main-path shape and its
    wider shapes; returns the JSON entry (main shape, bf16). 20
    back-to-back launches per timing at the main shape, so the wrapper's
    host overhead overlaps the previous launch's device work (fewer at
    the wider shapes, whose launches are long)."""
    entry = None
    t["module"]._load()
    for dtype, shape, kw in _runs(t):
        a = t["inputs"](dev, dtype, **kw)
        r = _fwd_check(layout, t, a, dtype, shape,
                       (10, 20) if shape == "main" else (3, 2))
        if dtype == torch.bfloat16 and shape == "main":
            entry = _entry(t["fwd_entry"], *r)
        del a
    return entry


def _rel_errs(got, want):
    """(max |err| / max |want|, mean |err| / mean |want|) in f32."""
    d = (got.detach().float() - want.detach().float()).abs()
    w = want.detach().float().abs()
    return (float(d.max() / w.max().clamp_min(1e-30)),
            float(d.mean() / w.mean().clamp_min(1e-30)))


def _bwd_check(label, names, got, want, dtype, keys_dtype):
    """Per output (max, mean) relative errors against BWD_TOL; returns
    (log text, max abs err) or raises."""
    tol, tol_mean = BWD_TOL[dtype]
    errs = {n: _rel_errs(x, y) for n, x, y in zip(names, got, want)}
    ok_ = all(e[0] <= tol and e[1] <= tol_mean for e in errs.values())
    ok_ &= all(bool(torch.isfinite(x.float()).all()) for x in got)
    ok_ &= got[0].dtype == keys_dtype
    max_abs = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want))
    text = (", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in errs.items())
            + f" (max/mean rel err; tol {tol}/{tol_mean}); max abs err "
            f"{max_abs:.3e}")
    if not ok_:
        raise AssertionError(f"{label} disagrees with plain in {dtype}: "
                             + text)
    return text, max_abs


BWD_NAMES = ("dkeys", "dq", "dw1cat", "dg", "db", "dw2", "dcb", "datt")


def _bwd_check_timed(layout, t, a, dtype, shape, reps):
    """One backward check of a layout's kernels against their plain
    version on the backward inputs ``a`` (``bwd_inputs``), the wrapper's
    call under ``set_sync_debug_mode("error")``; logs one line and
    returns (max abs err, kernel ms, plain ms, bound ms, bound_by)."""
    torch.cuda.synchronize()
    # the wrapper and its slot compaction must never wait on the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = t["bwd"](**a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = in_link_chunks(t["bwd_plain"], a, 2)
    text, max_abs = _bwd_check(f"{layout} backward kernel at {shape}",
                               BWD_NAMES, got, want, dtype, a["keys"].dtype)
    del got, want
    ms = time_ms(lambda: t["bwd"](**a), reps[0], per=reps[1])
    plain_ms = time_ms(lambda: in_link_chunks(t["bwd_plain"], a, 2), 3, 1)
    bound, bound_by, nv = t["bwd_bound"](a)
    log(f"kernel bwd {layout} {str(dtype)[6:]} {shape} ({_shape(a)}): "
        f"{text}; {nv} valid slots; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
    return max_abs, ms, plain_ms, bound, bound_by


def phase_kernel_bwd(dev, layout, t):
    """A layout's PE+attention backward kernels vs their plain version at
    its main-path shape and its wider shapes; returns the JSON entry."""
    entry = None
    t["module"]._load_bwd()
    for dtype, shape, kw in _runs(t):
        a = bwd_inputs(t["inputs"](dev, dtype, **kw))
        r = _bwd_check_timed(layout, t, a, dtype, shape,
                             (10, 10) if shape == "main" else (3, 2))
        if dtype == torch.bfloat16 and shape == "main":
            entry = _entry(t["bwd_entry"], *r)
        del a
    return entry


def phase_scatter(dev, card):
    """The scatter-add kernel vs its plain version at the main-path shape,
    with its traced device time (the output's zeroing apart from the
    kernel) and two torch yardsticks: the one-call ``index_add_`` over all
    rows, dead ones on the pad row, and ``index_add_`` over the live rows
    compacted beforehand (profile_kernels.scatter_report). Returns the
    JSON entry (library_ms: the one call)."""
    from lpformer_tpu_torch.ops import scatter
    from lpformer_tpu_torch.profile_kernels import scatter_report

    ids, ct, n, live = scatter_inputs(dev)
    r = scatter_report(card, "kernel", ids, ct, n, live, log=log)
    plain_ms = time_ms(
        lambda: scatter.scatter_rows_add_plain(ids, ct, n, live), 5, 1)
    log(f"scatter plain version {plain_ms:.4f} ms")
    return _entry(("scatter_rows_add",
                   "lpformer_tpu_torch/csrc/scatter_rows_add.cu",
                   "lpformer_tpu/ops/pallas/scatter.py:48"),
                  r["err"], r["ms"], plain_ms, r["bound"], r["bound_by"],
                  r["all_ms"])


def phase_link_attention(dev):
    """The per-link attention forward and backward kernels vs their plain
    versions at the bench's A/B shape, in f32 (the A/B's dtype, the JSON
    entries) and bf16 (the A/B's torch composition, their yardstick, is
    timed in phase_attention_ab), each wrapper's checked call under
    ``set_sync_debug_mode("error")``; returns the two JSON entries."""
    from lpformer_tpu_torch.ops import attention as at

    names = ("dkeys", "dq", "dw", "dr_bias", "datt")
    entries = None
    for dtype in (torch.float32, torch.bfloat16):
        a = measure.link_attention_inputs(dev, dtype)
        torch.cuda.synchronize()
        # the wrapper must never wait on the card
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = at._fwd(**a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        want = at.fused_link_attention_plain(**a)
        errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        mean_err = float((got[0] - want[0]).abs().mean())
        tol, tol_mean = TOL[dtype]
        if not (max(errs) <= tol and mean_err <= tol_mean
                and bool(torch.isfinite(got[0]).all())):
            raise AssertionError(f"link attention forward disagrees with "
                                 f"plain in {dtype}: {errs}, {mean_err}")
        ms = time_ms(lambda: at._fwd(**a), 10, per=20)
        plain_ms = time_ms(lambda: at.fused_link_attention_plain(**a), 5, 1)
        bound, bound_by, nv = measure.link_attention_bound_ms(a)
        log(f"kernel link attention {str(dtype)[6:]} (B={a['keys'].shape[0]}"
            f" C={a['keys'].shape[1]} Dk={a['keys'].shape[2]} "
            f"O={a['w'].shape[1]}): max abs err out/m/l "
            + "/".join(f"{e:.3e}" for e in errs) + f" (mean {mean_err:.3e};"
            f" tol {tol}, mean {tol_mean}); {nv} valid slots; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
            f"({bound_by})")
        fwd_entry = _entry(
            ("fused_link_attention_fwd",
             "lpformer_tpu_torch/csrc/link_attention_fwd.cu",
             "lpformer_tpu/ops/pallas/attention.py:42"),
            max(errs), ms, plain_ms, bound, bound_by)

        b = measure.link_attention_bwd_inputs(a)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = at.fused_link_attention_bwd(**b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        want = at.fused_link_attention_bwd_plain(**b)
        text, max_abs = _bwd_check("link attention backward", names, got,
                                   want, dtype, a["keys"].dtype)
        ms = time_ms(lambda: at.fused_link_attention_bwd(**b), 10, per=10)
        plain_ms = time_ms(lambda: at.fused_link_attention_bwd_plain(**b), 3,
                           1)
        bound, bound_by, nv = measure.link_attention_bwd_bound_ms(b)
        log(f"kernel bwd link attention {str(dtype)[6:]}: {text}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
            f"({bound_by})")
        if dtype == torch.float32:
            entries = (fwd_entry, _entry(
                ("fused_link_attention_bwd",
                 "lpformer_tpu_torch/csrc/link_attention_bwd.cu",
                 "lpformer_tpu/ops/pallas/attention.py:137"),
                max_abs, ms, plain_ms, bound, bound_by))
        del a, b, got, want
    return entries


def phase_attention_ab(dev, card):
    """The per-link attention op's own path, the bench's A/B (bench.py:
    824-871) at its shape: forward, and forward + backward, through
    fused_link_attention in f32 and bf16, each arm against the torch
    composition; returns the two kernels' launch counts, which must equal
    the op's calls."""
    from lpformer_tpu_torch.ops import attention as at
    from lpformer_tpu_torch.profile_kernels import ab_arms

    at.fused_link_attention.launches = 0
    at.fused_link_attention_bwd.launches = 0
    calls = [0, 0]
    for dtype in (torch.float32, torch.bfloat16):
        a = measure.link_attention_inputs(dev, dtype)
        arms = ab_arms(a)
        op_fwd, op_fb = arms["op"]

        def counted_fwd():
            calls[0] += 1
            return op_fwd()

        def counted_fb():
            calls[0] += 1
            calls[1] += 1
            return op_fb()

        got = counted_fb()
        want = arms["composition"][1]()
        errs = [_rel_errs(x, y)[0] for x, y in zip(got, want)]
        if not all(bool(torch.isfinite(x.float()).all()) for x in got):
            raise AssertionError("the A/B's outputs are not finite")
        if dtype == torch.float32 and max(errs) > AB_TOL:
            raise AssertionError(f"the op disagrees with the torch "
                                 f"composition: {errs}")
        fwd_ms = time_ms(counted_fwd, 5, per=5)
        comp_ms = time_ms(arms["composition"][0], 5, per=5)
        fb_ms = time_ms(counted_fb, 5, per=5)
        comp_fb_ms = time_ms(arms["composition"][1], 5, per=5)
        log(f"attention A/B {str(dtype)[6:]}: op vs torch composition max "
            f"rel err out/dkeys/dq " + "/".join(f"{e:.2e}" for e in errs)
            + (f" (tol {AB_TOL})" if dtype == torch.float32 else
               " (the composition rounds xj to bf16; not compared)")
            + f"; forward op {fwd_ms:.4f} ms vs composition {comp_ms:.4f} "
            f"ms; forward + backward op {fb_ms:.4f} ms vs composition "
            f"{comp_fb_ms:.4f} ms  [{card}]")
        del a, arms, got, want
    launches = (at.fused_link_attention.launches,
                at.fused_link_attention_bwd.launches)
    log(f"attention A/B launches: forward {launches[0]}, backward "
        f"{launches[1]} (calls {calls[0]}, {calls[1]})")
    if list(launches) != calls:
        raise AssertionError(f"A/B launches {launches} != calls {calls}")
    return {"fused_link_attention_fwd": launches[0],
            "fused_link_attention_bwd": launches[1]}


def load_dataset(dev, data=None):
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.data.synthetic import synthetic_dataset

    data = data or presets.COLLAB_LIKE_DATA
    t0 = time.perf_counter()
    ds = synthetic_dataset(**data, device=dev)
    log(f"dataset: {time.perf_counter() - t0:.1f} s host build "
        f"({ds.num_nodes} nodes, {ds.graph.num_edges} directed edges)")
    return ds


def _eval_links(ds, batch):
    return np.concatenate([ds.train_pos_val, ds.valid_pos, ds.test_pos,
                           ds.valid_neg, ds.test_neg])[:batch]


def _extract(ds, cfg, links, train, dev):
    """One batch's context tables: eval mode, or train mode with the
    batch's masked ranks and attention subsampling from a fixed seed."""
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.ops.context import extract_context

    tl = torch.as_tensor(links, dtype=torch.int64, device=dev)
    src, tgt = tl[:, 0], tl[:, 1]
    if not train:
        return extract_context(ds.graph.adj_rows, ds.graph.ppr_rows, src, tgt,
                               cfg.context)
    w = torch.ones(len(links), device=dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, src, tgt,
                                  ds.mask_mult_device, weight=w)
    return extract_context(ds.graph.adj_rows, ds.graph.ppr_rows, src, tgt,
                           cfg.context, mask_ranks=mr,
                           gen=torch.Generator(device=dev).manual_seed(5),
                           train=True)


def phase_lookup(dev, ds, cfg, batch):
    """The fused lookup kernel vs its plain version, bit for bit, at each
    shape one batch's context extraction (eval mode, and train mode with
    batch masking) gives it on the collab-like dataset, beside the
    searchsorted route at the same shape; and the two routes' context
    tables, which must be identical. Returns the JSON entry (the shape of
    the most work)."""
    from lpformer_tpu_torch.ops import lookup, search
    from lpformer_tpu_torch.profile_kernels import traced_ms

    recorded = []
    real_route = search.fused_row_member_values
    real_lookup = search.fused_lookup

    def route(rows, queries, value_arrays=(), defaults=()):
        recorded.append([rows, queries, list(value_arrays), defaults])
        return real_route(rows, queries, value_arrays, defaults)

    def kernel(rows, queries, lanes):
        recorded[-1].append(lanes)
        return real_lookup(rows, queries, lanes)

    tabs = {}
    for mode in ("eval", "train"):
        links = (_eval_links(ds, batch) if mode == "eval"
                 else ds.train_pos[:batch])
        search.fused_row_member_values, search.fused_lookup = route, kernel
        os.environ[FUSED_LOOKUP] = "1"
        try:
            fused = _extract(ds, cfg, links, mode == "train", dev)
        finally:
            os.environ.pop(FUSED_LOOKUP)
            search.fused_row_member_values = real_route
            search.fused_lookup = real_lookup
        default = _extract(ds, cfg, links, mode == "train", dev)
        for f in ("ids", "cls", "valid", "counts", "overflow", "src_ppr",
                  "tgt_ppr"):
            if not torch.equal(getattr(fused, f), getattr(default, f)):
                raise AssertionError(f"{mode}-mode context table field {f} "
                                     f"differs between the lookup routes")
        tabs[mode] = fused
    log(f"lookup routes: eval-mode and train-mode context tables of a batch "
        f"of {batch} identical on both routes ({len(recorded)} fused "
        f"lookups)")

    entry, seen = None, set()
    for rows, queries, vals, defaults, lanes in recorded:
        b, k = rows.shape
        q, n_l = queries.shape[1], lanes.shape[1]
        if (k, q, n_l) in seen:
            continue
        seen.add((k, q, n_l))
        r32, q32 = rows.to(torch.int32).contiguous(), queries.to(
            torch.int32).contiguous()
        got = lookup.fused_lookup(r32, q32, lanes)
        torch.cuda.synchronize()
        if not torch.equal(got, lookup.fused_lookup_plain(r32, q32, lanes)):
            raise AssertionError(f"fused lookup differs from plain at "
                                 f"B={b} K={k} Q={q} L={n_l}")
        ms = time_ms(lambda: lookup.fused_lookup(r32, q32, lanes), 10,
                     per=20)
        busy, _ = traced_ms(lambda: lookup.fused_lookup(r32, q32, lanes))
        plain_ms = time_ms(lambda: lookup.fused_lookup_plain(r32, q32, lanes),
                           5, 1)
        route_ms = time_ms(lambda: real_route(rows, queries, vals, defaults),
                           10, per=20)
        search_ms = time_ms(lambda: search.row_member_values(
            rows, queries, vals, defaults), 10, per=20)
        bound, bound_by = measure.lookup_bound_ms(r32, q32, lanes)
        log(f"kernel fused lookup B={b} K={k} Q={q} L={n_l}: bit-exact; "
            f"kernel {ms:.4f} ms (traced {busy:.4f}), plain {plain_ms:.4f} "
            f"ms, bound {bound:.5f} ms ({bound_by}); fused route (packing + "
            f"kernel) {route_ms:.4f} ms, searchsorted route {search_ms:.4f} "
            f"ms")
        if entry is None or k * q * n_l > entry[0]:
            entry = (k * q * n_l, _entry(
                ("fused_lookup", "lpformer_tpu_torch/csrc/fused_lookup.cu",
                 "lpformer_tpu/ops/pallas/lookup.py:51"),
                0.0, ms, plain_ms, bound, bound_by))
    return entry[1]


def phase_lookup_route(dev, card, ds, tabs, batch):
    """The collab-like combined table's eval sweep and one training step on
    the fused lookup route (LPFORMER_FUSED_LOOKUP=1) against the default
    route: identical metrics and loss, and the fused lookup's launches
    equal to the route's calls. Returns the launch count."""
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops import lookup, masking, search
    from lpformer_tpu_torch.train import optim, step as step_mod

    cfg = tabs["combined"]["cfg"]
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    nodrop = dataclasses.replace(cfg, dropout=0.0, gnn_drop=0.0,
                                 att_drop=0.0)
    for x in optim.tree_leaves(params):
        x.requires_grad_(True)
    pos = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    neg = torch.randint(0, ds.num_nodes, (2, batch),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    w = torch.ones(batch, device=dev)

    def run():
        res = harness.test_standard(params, cfg, ds, batch_size=batch)
        mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0],
                                      pos[:, 1], ds.mask_mult_device,
                                      weight=w)
        loss = step_mod.loss_fn(params, nodrop, ds.graph, pos[:, 0],
                                pos[:, 1], neg[0], neg[1], w, mr, None)
        loss.backward()
        torch.cuda.synchronize()
        return res, float(loss.detach())

    res_d, loss_d = run()
    calls = [0]
    real_route = search.fused_row_member_values

    def route(*a, **kw):
        calls[0] += 1
        return real_route(*a, **kw)

    lookup.fused_lookup.launches = 0
    search.fused_row_member_values = route
    os.environ[FUSED_LOOKUP] = "1"
    try:
        t0 = time.perf_counter()
        res_f, loss_f = run()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop(FUSED_LOOKUP)
        search.fused_row_member_values = real_route
    launches = lookup.fused_lookup.launches
    log(f"fused lookup route (collab-like combined): test_standard + one "
        f"training step in {wall * 1e3:.1f} ms; metrics "
        + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}"
                    for k, v in res_f.items())
        + f" (default route "
        + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}"
                    for k, v in res_d.items())
        + f"); loss {loss_f:.6f} (default {loss_d:.6f}); {launches} fused "
        f"lookup launches for {calls[0]} route calls  [{card}]")
    if res_f != res_d or loss_f != loss_d:
        raise AssertionError("the fused lookup route changed the metrics or "
                             "the loss")
    if launches != calls[0] or launches < 1:
        raise AssertionError(f"{launches} fused lookup launches for "
                             f"{calls[0]} route calls")
    return launches


def phase_main(dev, card, ds, layout, t, cfg=None, batch=None):
    """The eval path end to end at a preset (presets.py) of a table
    layout; returns the forward kernel's launch count."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops.context import extract_context

    cfg = cfg or t["cfg"]
    batch = batch or presets.COLLAB_LIKE_BATCH
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)

    splits = [ds.train_pos_val, ds.valid_pos, ds.test_pos, ds.valid_neg,
              ds.test_neg]
    n_batches = sum(-(-len(s) // batch) for s in splits)
    t["op"].launches = 0
    t0 = time.perf_counter()
    res = harness.test_standard(params, cfg, ds, batch_size=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = t["op"].launches
    log(f"test_standard {layout}: {wall * 1e3:.1f} ms wall, {n_batches} "
        f"batches, {launches} kernel launches; "
        + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}"
                    for k, v in res.items()) + f" (train/valid/test)  [{card}]")
    if launches != n_batches * cfg.trans_layers:
        raise AssertionError(
            f"{launches} kernel launches for {n_batches} score batches")
    for k, v in res.items():
        if not all(0.0 <= x <= 1.0 for x in v):
            raise AssertionError(f"{k} out of range: {v}")

    with torch.no_grad():
        # every eval link's score (the sweep above returns metrics only)
        X = lt.propagate(params, cfg, ds.graph)
        score_fn = harness.make_score_fn(cfg)
        links = np.concatenate(splits)
        every = harness.score_edges(score_fn, params, ds.graph, X, links,
                                    batch)
        if every.shape != (len(links),) or not np.isfinite(every).all():
            raise AssertionError("eval scores not finite or of the wrong "
                                 "shape")

        # one full batch of real eval links: scores, kernel vs plain path
        src, tgt = _scores_vs_plain(dev, ds.graph, t, score_fn, params, X,
                                    links[:batch], layout)
        orig = getattr(lt, t["model_op"])

        # where one batch's time goes, each stage timed on its own
        captured = []

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = orig(*a, **kw)
            e1.record()
            captured.append((e0, e1, a, kw))
            return r

        setattr(lt, t["model_op"], timed)
        try:
            total_ms = time_ms(
                lambda: score_fn(params, ds.graph, X, src, tgt), 5)
        finally:
            setattr(lt, t["model_op"], orig)
        torch.cuda.synchronize()
        kern_ms = statistics.median(c[0].elapsed_time(c[1])
                                    for c in captured)
        ctx_ms = time_ms(lambda: extract_context(
            ds.graph.adj_rows, ds.graph.ppr_rows, src, tgt, cfg.context), 5)
        prop_ms = time_ms(lambda: lt.propagate(params, cfg, ds.graph), 3, 1)
        names = inspect.signature(t["plain"]).parameters
        real = dict(zip(names, captured[-1][2]), **captured[-1][3])
        bound, _, nv = t["bound"](real)
        per_link = real["valid"].sum(1).float()
        log(f"valid slots per link ({layout}): mean {per_link.mean():.2f}, "
            f"p50 {per_link.median():.0f}, p99 {per_link.quantile(0.99):.0f}"
            f", max {per_link.max():.0f} of {real['valid'].shape[1]}")
        log(f"batch of {batch} ({layout}): score {total_ms:.3f} ms = context "
            f"{ctx_ms:.3f} + kernel {kern_ms:.3f} (bound {bound:.5f}) + "
            f"rest {total_ms - ctx_ms - kern_ms:.3f} (key gather, MLPs); "
            f"propagate {prop_ms:.3f} ms; {batch / total_ms * 1e3:.0f} "
            f"links/s scored  [{card}]")
    return launches


def _scores_vs_plain(dev, graph, t, score_fn, params, X, links, label):
    """One batch of links scored through the layout's kernel and through
    its plain version: finite, of the right shape, within SCORE_TOL.
    Returns the batch's (src, tgt) on the card."""
    from lpformer_tpu_torch.models import link_transformer as lt

    tl = torch.as_tensor(links, dtype=torch.int64, device=dev)
    src, tgt = tl[:, 0], tl[:, 1]
    scores = score_fn(params, graph, X, src, tgt)
    if scores.shape != (len(links),) or not torch.isfinite(scores).all():
        raise AssertionError("scores not finite or of the wrong shape")
    orig = getattr(lt, t["model_op"])
    setattr(lt, t["model_op"], t["plain"])
    try:
        plain = score_fn(params, graph, X, src, tgt)
    finally:
        setattr(lt, t["model_op"], orig)
    err = float((scores - plain).abs().max())
    log(f"scores {label} kernel vs plain path ({len(links)} links): max abs "
        f"err {err:.3e} (tol {SCORE_TOL})")
    if err > SCORE_TOL:
        raise AssertionError("kernel path disagrees with the plain path")
    return src, tgt


def _plain_training_path(tabs):
    """Route the model's fused ops and the gathers' scatter through their
    plain versions (autograd included), for comparison on the card;
    returns a function that restores the kernels."""
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops import scatter

    saved = ({t["model_op"]: getattr(lt, t["model_op"])
              for t in tabs.values()}, scatter.scatter_rows_add)
    for t in tabs.values():
        setattr(lt, t["model_op"], t["plain_op"])
    scatter.scatter_rows_add = scatter.scatter_rows_add_plain

    def restore():
        for name, op in saved[0].items():
            setattr(lt, name, op)
        scatter.scatter_rows_add = saved[1]

    return restore


def _counters(tabs):
    """Every kernel wrapper's launch counter, by JSON entry name."""
    from lpformer_tpu_torch.ops import attention, lookup, scatter

    out = {"scatter_rows_add": scatter.scatter_rows_add,
           "fused_link_attention_fwd": attention.fused_link_attention,
           "fused_link_attention_bwd": attention.fused_link_attention_bwd,
           "fused_lookup": lookup.fused_lookup}
    for t in tabs.values():
        out[t["fwd_entry"][0]] = t["op"]
        out[t["bwd_entry"][0]] = t["bwd"]
    return out


def _fresh_params(dev, cfg, in_dim):
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.train import optim

    p = lt.init_lpformer(torch.Generator().manual_seed(0), cfg, in_dim=in_dim,
                         device=dev)
    for x in optim.tree_leaves(p):
        x.requires_grad_(True)
    return p


def _compare_steps(label, a, b, leaves_with_path, loss_tol=STEP_LOSS_TOL,
                   grad_tol=STEP_GRAD_TOL):
    """(loss, grads) of step ``a`` against step ``b``: the loss's |diff|
    and every leaf's ||a - b|| / ||b|| within the tolerances, a's grads
    finite; logs one line and returns whether the two are bit-equal."""
    dl = abs(float(a[0]) - float(b[0]))
    rel = [float((x - y).norm() / y.norm().clamp_min(1e-30))
           for x, y in zip(a[1], b[1])]
    worst = leaves_with_path[rel.index(max(rel))][0]
    equal = bool(torch.equal(a[0], b[0])) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    log(f"{label}: loss {float(a[0]):.6f} vs {float(b[0]):.6f} (|diff| "
        f"{dl:.2e}, tol {loss_tol}); grad leaves {len(rel)}, max rel L2 err "
        f"{max(rel):.2e} at {'/'.join(map(str, worst))} (median "
        f"{statistics.median(rel):.2e}, tol {grad_tol}); bit-equal {equal}")
    if (dl > loss_tol or max(rel) > grad_tol
            or not all(bool(torch.isfinite(x).all()) for x in a[1])):
        raise AssertionError(f"{label} disagree")
    return equal


def _step_pair(dev, ds, layout, tabs, cfg, batch, mask_input=False):
    """One training step, dropout off and fixed negatives, through the
    kernels and through the plain versions: the loss and every gradient
    leaf must agree (STEP_LOSS_TOL, STEP_GRAD_TOL; in f32 the STEP_F32
    pair). With ``mask_input`` the step propagates twice, the positive
    half over the batch-masked weights."""
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.train import optim, step as step_mod

    nodrop = dataclasses.replace(cfg, dropout=0.0, gnn_drop=0.0,
                                 att_drop=0.0, feat_drop=0.0, pred_drop=0.0)
    params = _fresh_params(dev, nodrop, int(ds.graph.x.shape[1]))
    leaves = optim.tree_leaves(params)
    pos = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    neg = torch.randint(0, ds.num_nodes, (2, batch),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    w = torch.ones(batch, device=dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)
    prop_w = (masking.mask_edge_weights(mr, ds.graph.edge_rank,
                                        (ds.graph.edge_w > 0).float())
              if mask_input else None)

    def loss_and_grads():
        loss = step_mod.loss_fn(params, nodrop, ds.graph, pos[:, 0],
                                pos[:, 1], neg[0], neg[1], w, mr, None,
                                prop_w, mask_input)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads()
    restore = _plain_training_path(tabs)
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        restore()
    _compare_steps(
        f"train step {layout} (dim {cfg.dim}, batch {batch}, "
        f"{cfg.matmul_dtype}{', mask_input' if mask_input else ''}) kernels "
        f"vs plain", (loss_k, grads_k), (loss_p, grads_p),
        optim.tree_leaves_with_path(params),
        *((STEP_LOSS_TOL, STEP_GRAD_TOL) if cfg.mm_dtype
          else (STEP_F32_LOSS_TOL, STEP_F32_GRAD_TOL)))


def _timed_steps(dev, card, ds, layout, cfg, batch, steps, skip=2,
                 mask_input=False):
    """``steps`` training steps with the preset's dropouts through the
    functions train_loop's step runs (masking, loss_fn, backward, the
    fused optimizer; with ``mask_input`` the masked propagation weights
    and two propagations), CUDA events around the forward, backward and
    optimizer; logs the medians over the steps after the first ``skip``
    and the peak memory, and returns (every step's loss, the median step
    ms)."""
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.train import optim, step as step_mod

    params = _fresh_params(dev, cfg, int(ds.graph.x.shape[1]))
    opt = optim.make_optimizer(1e-3, steps_per_epoch=steps)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.ones(batch, device=dev)
    mult = ds.mask_mult_device
    bin_w = (ds.graph.edge_w > 0).float()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(steps):
        links = torch.as_tensor(
            ds.train_pos[i * batch:(i + 1) * batch]).to(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        negs = torch.randint(0, ds.num_nodes, (2, batch), generator=gen,
                             device=dev, dtype=links.dtype)
        mr = masking.batch_mask_ranks(ds.graph.adj_rows, links[:, 0],
                                      links[:, 1], mult, weight=w)
        prop_w = (masking.mask_edge_weights(mr, ds.graph.edge_rank, bin_w)
                  if mask_input else None)
        loss = step_mod.loss_fn(params, cfg, ds.graph, links[:, 0],
                                links[:, 1], negs[0], negs[1], w, mr, gen,
                                prop_w, mask_input)
        ev[1].record()
        loss.backward()
        ev[2].record()
        grads = optim.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            params)
        upd, opt_state = opt.update(grads, opt_state, params)
        optim.apply_updates(params, upd)
        for p in optim.tree_leaves(params):
            p.grad = None
        ev[3].record()
        ev[3].synchronize()
        losses.append(loss.detach())
        if i >= skip:
            times.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    fwd, bwd, upd_ms = (statistics.median(x[j] for x in times)
                        for j in range(3))
    total = statistics.median(sum(x) for x in times)
    log(f"train step {layout} (dim {cfg.dim}; median of {len(times)}, "
        f"batch {batch}): {total:.3f} ms = forward {fwd:.3f} + backward "
        f"{bwd:.3f} + optimizer {upd_ms:.3f}; {batch / total * 1e3:.0f} "
        f"positive links/s; peak memory of the steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    return losses, total


def phase_train(dev, card, ds, layout, tabs, cfg=None, batch=None, epochs=1,
                timed_steps=5):
    """The training path at a preset of a table layout: one step through
    the kernels against the plain path, one epoch of train_loop with its
    test_standard, then the timed steps; returns each kernel's launch
    count in the train_loop run."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.train import trainer
    from lpformer_tpu_torch.utils.logger import ResultsLogger

    t = tabs[layout]
    cfg = cfg or t["cfg"]
    batch = batch or presets.COLLAB_LIKE_BATCH
    _step_pair(dev, ds, layout, tabs, cfg, batch)

    # the main path: train_loop, one test_standard at its end
    args = trainer.TrainArgs(epochs=epochs, batch_size=batch,
                             test_batch_size=batch, eval_steps=epochs,
                             seed=0)
    loggers = {k: ResultsLogger(1) for k in
               ("Hits@20", "Hits@50", "Hits@100", "MRR")}
    losses = []
    steps = epochs * math.ceil(len(ds.train_pos) / batch)
    splits = [ds.train_pos_val, ds.valid_pos, ds.test_pos, ds.valid_neg,
              ds.test_neg]
    eval_batches = sum(-(-len(s) // batch) for s in splits)
    counters = _counters(tabs)
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    trainer.train_loop(args, cfg, ds, loggers, 0, step_losses=losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    want = dict.fromkeys(counters, 0)
    want[t["fwd_entry"][0]] = (2 * steps + eval_batches) * cfg.trans_layers
    want[t["bwd_entry"][0]] = 2 * steps * cfg.trans_layers
    want["scatter_rows_add"] = 2 * steps * cfg.trans_layers
    lv = torch.stack(losses).cpu()
    res = {k: v.results[0][-1] for k, v in loggers.items()}
    log(f"train_loop {layout} (dim {cfg.dim}): {epochs} epoch(s), "
        f"{len(losses)} steps of {batch}, {wall:.1f} s wall incl. one "
        f"test_standard; loss first {float(lv[0]):.4f} last "
        f"{float(lv[-1]):.4f} mean {float(lv.mean()):.4f}; " + ", ".join(
            f"{k} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}" for k, v in res.items())
        + f"; launches {launches} (want {want})  [{card}]")
    if len(losses) != steps or not bool(torch.isfinite(lv).all()):
        raise AssertionError("a training loss is not finite")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for k, v in res.items():
        if not all(0.0 <= x <= 1.0 for x in v):
            raise AssertionError(f"{k} out of range: {v}")

    _timed_steps(dev, card, ds, layout, cfg, batch, timed_steps + 2)
    return launches


def phase_heart(dev, card, tabs):
    """The HeaRT sweep: the collab-like dataset with 100 negatives per
    eval positive (a choice of this script; no HeaRT file fixes it), on
    the combined table, through run_eval -> test_standard(heart=True):
    the per-positive MRR in [0, 1] and the forward kernel's launches equal
    to the score batches."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.train import trainer

    ds = load_dataset(dev, dict(presets.COLLAB_LIKE_DATA, heart=True,
                                heart_negs=100))
    t, batch = tabs["combined"], presets.COLLAB_LIKE_BATCH
    cfg = t["cfg"]
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    sizes = [len(ds.train_pos_val), len(ds.valid_pos), len(ds.test_pos),
             ds.valid_neg.shape[0] * ds.valid_neg.shape[1],
             ds.test_neg.shape[0] * ds.test_neg.shape[1]]
    n_batches = sum(-(-m // batch) for m in sizes)
    t["op"].launches = 0
    t0 = time.perf_counter()
    res = trainer.run_eval(params, cfg, ds,
                           trainer.TrainArgs(test_batch_size=batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = t["op"].launches
    log(f"HeaRT sweep (collab-like combined, {ds.valid_neg.shape[1]} "
        f"negatives per positive): run_eval -> test_standard(heart=True) "
        f"{wall * 1e3:.1f} ms wall, {sum(sizes)} links in {n_batches} "
        f"batches, {launches} forward kernel launches; "
        + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}"
                    for k, v in res.items()) + f" (train/valid/test)  [{card}]")
    if list(res) != ["MRR"] or not all(0.0 <= x <= 1.0 for x in res["MRR"]):
        raise AssertionError(f"HeaRT metrics out of range: {res}")
    if launches != n_batches * cfg.trans_layers:
        raise AssertionError(f"{launches} launches for {n_batches} batches")


def _device_bytes(obj):
    """Bytes of every tensor a (nested) dataclass holds."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_device_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(_device_bytes(x) for x in obj)
    return 0


def phase_citation2_build(dev):
    """The citation2-like preset's dataset (measure.citation2_like_dataset:
    1,000,000 nodes, 5,000,000 train edges, 1000 negative targets per eval
    positive): its propagation layout must be the BlockedBELL of 8 x 8
    tiles, and no ELL."""
    t0 = time.perf_counter()
    ds = measure.citation2_like_dataset(dev)
    g = ds.graph
    log(f"citation2-like dataset: {time.perf_counter() - t0:.1f} s host "
        f"build ({ds.num_nodes} nodes, {g.num_edges} directed edges); "
        f"layout {'bbell' if g.bbell is not None else 'none'} kb "
        f"{None if g.bbell is None else g.bbell.kb}, "
        f"{None if g.bbell is None else g.bbell.slot_total} slots in "
        f"{0 if g.bbell is None else sum(x is not None for x in g.bbell.tiles)}"
        f" tiles, ell {g.ell is not None}, blk {g.blk is not None}; the "
        f"bundle holds {_device_bytes(g) / 2**30:.2f} GiB on the card")
    if g.bbell is None or g.bbell.kb != 8 or g.ell is not None:
        raise AssertionError("the citation2-like bundle must carry the "
                             "BlockedBELL with kb = 8 and no ELL")
    return ds


def phase_citation2_spmm(dev, card, ds, dim, batch):
    """One GCN layer's SpMM on the citation2-like graph at [N, dim], f32
    and with bf16 gather, through spmm_bbell, against a single BucketedELL
    and a static BlockedCOO built over the same graph for this check only
    (an A/B of the layouts; the layout rule stays the JAX package's). Then
    the mask_input arm: one batch of ``batch`` train links masked out of
    the propagation weights (mask_edge_weights), renormalised on the card
    (gcn_norm_device), through the BlockedCOO re-weighted by its edge ids
    (the JAX package's big-graph mask_input layout) against the
    BucketedELL re-weighted by its slots' edge ids."""
    from lpformer_tpu_torch.graph.containers import BlockedCOO, BucketedELL
    from lpformer_tpu_torch.ops import masking, spmm

    g = ds.graph
    s, d, w = (g.edge_src.cpu().numpy(), g.edge_dst.cpu().numpy(),
               g.w_norm.cpu().numpy())
    t0 = time.perf_counter()
    bell = BucketedELL.from_sorted_coo(s, d, g.num_nodes, w_norm=w).to(dev)
    blk = BlockedCOO.from_coo(s, d, g.num_nodes, w_norm=w,
                              with_edge_ids=True).to(dev)
    log(f"SpMM A/B layouts built in {time.perf_counter() - t0:.1f} s: "
        f"BucketedELL {len(bell.caps)} tiers {bell.slot_total} slots (with "
        f"edge ids), BlockedCOO {blk.slot_total} slots (with edge ids), "
        f"BlockedBELL {g.bbell.slot_total} slots")
    x = torch.randn(g.num_nodes, dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

    def ab(label, arms, ref):
        for gd in (None, torch.bfloat16):
            with torch.no_grad():
                outs = {k: f(gd) for k, f in arms.items()}
                errs = {k: float((v - outs[ref]).abs().max())
                        for k, v in outs.items() if k != ref}
                ms = {k: time_ms(lambda: f(gd), 3, 1)
                      for k, f in arms.items()}
            log(f"SpMM{label} [{g.num_nodes}, {dim}] "
                f"{'f32' if gd is None else 'bf16'} gather: max abs err vs "
                f"{ref} " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f" (tol {SPMM_TOL}); " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in ms.items()) + f"  [{card}]")
            if max(errs.values()) > SPMM_TOL or not all(
                    bool(torch.isfinite(v).all()) for v in outs.values()):
                raise AssertionError(f"the SpMM{label} layouts disagree")
            del outs

    ab("", {
        "BlockedBELL": lambda gd: spmm.spmm_bbell(g.bbell, x, diag=g.w_diag,
                                                  gather_dtype=gd),
        "BucketedELL": lambda gd: spmm.spmm_bell(bell, None, x,
                                                 diag=g.w_diag,
                                                 gather_dtype=gd),
        "BlockedCOO": lambda gd: spmm.spmm_blocked(
            blk, None, x, diag=g.w_diag, gather_dtype=gd),
    }, "BucketedELL")

    links = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    mr = masking.batch_mask_ranks(g.adj_rows, links[:, 0], links[:, 1],
                                  ds.mask_mult_device,
                                  weight=torch.ones(batch, device=dev))
    prop_w = masking.mask_edge_weights(mr, g.edge_rank,
                                       (g.edge_w > 0).float())
    w_norm, diag = spmm.gcn_norm_device(g.edge_src, g.edge_dst, prop_w,
                                        g.num_nodes)
    log(f"mask_input arm: {int((prop_w == 0).sum())} of {g.num_edges} "
        f"propagation edges masked by a batch of {batch} train links")
    ab(" masked, re-weighted", {
        "BlockedCOO": lambda gd: spmm.spmm_blocked(
            blk, w_norm, x, diag=diag, gather_dtype=gd),
        "BucketedELL": lambda gd: spmm.spmm_bell(bell, w_norm, x, diag=diag,
                                                 gather_dtype=gd),
    }, "BucketedELL")
    del bell, blk, x, w_norm, diag, prop_w
    torch.cuda.empty_cache()


# The draws of rows 1-2 at the citation2-like widths: (label, valid-slot
# counts, dtypes). The preset's density first (timed), then the
# collab-like spread (3% full links, whose runs cross tiles of 64 slots)
# in bf16 and f32, and every slot valid in bf16. In f32 with every slot
# valid (3.1M slots) the slopes of the ReLU and the leaky ReLU flip where
# their inputs lie within f32 rounding of 0, and the plain version moves
# as far when its inputs move by one ulp: past BWD_TOL's f32 bounds in
# both cases (``python -m lpformer_tpu_torch.profile_kernels --kinks``).
CITATION2_DRAWS = (
    ("citation2-like", measure.citation2_link_counts, (torch.bfloat16,)),
    ("citation2-like widths, collab-like spread",
     measure.collab_link_counts, (torch.bfloat16, torch.float32)),
    ("citation2-like widths, every slot valid", measure.full_link_counts,
     (torch.bfloat16,)),
)


def phase_citation2_kernels(dev, card, tabs, cfg, batch, n_rows):
    """Rows 1-3 at the citation2-like widths (combined table, B = batch, C
    = the combined budget, O = dh = dim, K = 3): rows 1-2 drawn as
    CITATION2_DRAWS lists, forward and backward against their plain
    versions (TOL, BWD_TOL); the scatter over [B, C, dim] into ``n_rows``
    rows, at the preset's density, beside index_add_."""
    from lpformer_tpu_torch.ops import scatter
    from lpformer_tpu_torch.profile_kernels import scatter_report

    t = tabs["combined"]
    for label, counts, dtypes in CITATION2_DRAWS:
        reps = (5, 5) if counts is measure.citation2_link_counts else (3, 2)
        for dtype in dtypes:
            a = t["inputs"](dev, dtype, b=batch, c=cfg.budget_combined,
                            o=cfg.dim, dh=cfg.dim, counts=counts)
            _fwd_check("combined", t, a, dtype, label, reps)
            a = bwd_inputs(a)
            _bwd_check_timed("combined", t, a, dtype, label, reps)
            del a
            torch.cuda.empty_cache()
    ids, ct, n, live = scatter_inputs(dev, b=batch, c=cfg.budget_combined,
                                      d=cfg.dim, n=n_rows,
                                      counts=measure.citation2_link_counts)
    scatter_report(card, "citation2-like", ids, ct, n, live, log=log)
    plain_ms = time_ms(
        lambda: scatter.scatter_rows_add_plain(ids, ct, n, live), 3, 1)
    log(f"scatter citation2-like plain version {plain_ms:.4f} ms")
    del ids, ct, live
    torch.cuda.empty_cache()


def _count_quantiles(counts):
    q = torch.quantile(counts.float(), torch.linspace(0, 1, 21,
                                                      device=counts.device))
    return ", ".join(f"{x:.0f}" for x in q.tolist())


def phase_citation2_eval(dev, card, ds, tabs, cfg, batch):
    """run_eval -> test_citation2 at test batch ``batch``: every score
    finite, MRR in [0, 1], the forward kernel's launches equal to the
    score batches, one batch of the negative sweep through the kernel
    within SCORE_TOL of the plain path; propagate ms and links/s."""
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops.context import extract_context
    from lpformer_tpu_torch.train import trainer

    t = tabs["combined"]
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    sizes = [ds.valid_neg.size, len(ds.valid_pos), len(ds.test_pos),
             ds.test_neg.size]
    n_batches = sum(-(-m // batch) for m in sizes)
    scored = []
    real = harness.score_edges

    def recording(*a, **kw):
        scored.append(real(*a, **kw))
        return scored[-1]

    harness.score_edges = recording
    t["op"].launches = 0
    try:
        t0 = time.perf_counter()
        res = trainer.run_eval(params, cfg, ds,
                               trainer.TrainArgs(test_batch_size=batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        harness.score_edges = real
    launches = t["op"].launches
    links = sum(len(x) for x in scored)
    with torch.no_grad():
        prop_ms = time_ms(lambda: lt.propagate(params, cfg, ds.graph), 2, 1)
    log(f"run_eval -> test_citation2 (citation2-like, batch {batch}): "
        f"{wall * 1e3:.1f} ms wall, {links} links in {n_batches} batches, "
        f"{launches} forward kernel launches; MRR "
        + "/".join(f"{x:.4f}" for x in res["MRR"]) + " (train/valid/test); "
        f"propagate {prop_ms:.1f} ms; {links / wall:.0f} links/s over the "
        f"sweep  [{card}]")
    if [len(x) for x in scored] != sizes or not all(
            np.isfinite(x).all() for x in scored):
        raise AssertionError("citation2 scores not finite or of the wrong "
                             "shape")
    if list(res) != ["MRR"] or not all(0.0 <= x <= 1.0 for x in res["MRR"]):
        raise AssertionError(f"citation2 MRR out of range: {res}")
    if launches != n_batches * cfg.trans_layers:
        raise AssertionError(f"{launches} launches for {n_batches} batches")

    # the first batch of the negative sweep: kernel vs plain, and its
    # valid slots per link beside a batch of train links (train mode)
    k = ds.valid_neg.shape[1]
    links = np.stack([np.repeat(ds.valid_pos[:, 0], k),
                      ds.valid_neg.reshape(-1)], axis=1)[:batch]
    with torch.no_grad():
        X = lt.propagate(params, cfg, ds.graph)
        src, tgt = _scores_vs_plain(dev, ds.graph, t, harness.make_score_fn(
            cfg), params, X, links, "citation2-like")
        ctx = extract_context(ds.graph.adj_rows, ds.graph.ppr_rows, src, tgt,
                              cfg.context)
        train = _extract(ds, cfg, ds.train_pos[:batch], True, dev)
    for label, c in (("eval sweep", ctx), ("train", train)):
        n = c.valid.sum(1)
        log(f"valid slots per link (citation2-like {label} batch): mean "
            f"{n.float().mean():.2f}, quantiles 0-100% by 5: "
            f"{_count_quantiles(n)} of {c.valid.shape[1]}")


def phase_citation2_train(dev, card, ds, tabs, cfg, batch, steps=8):
    """The citation2-like training step: one step through the kernels
    against the plain versions (dropout off, fixed negatives), then
    ``steps`` steps with the default dropouts, every loss finite and rows
    1-3 launched once per call."""
    _step_pair(dev, ds, "combined", tabs, cfg, batch)
    t = tabs["combined"]
    counters = _counters(tabs)
    for f in counters.values():
        f.launches = 0
    losses, _ = _timed_steps(dev, card, ds, "combined (citation2-like)",
                             cfg, batch, steps)
    launches = {n: f.launches for n, f in counters.items()}
    want = dict.fromkeys(counters, 0)
    for name in (t["fwd_entry"][0], t["bwd_entry"][0], "scatter_rows_add"):
        want[name] = 2 * steps * cfg.trans_layers
    lv = torch.stack(losses).cpu()
    log(f"citation2-like steps: losses " + ", ".join(
        f"{x:.4f}" for x in lv.tolist()) + f"; launches {launches}")
    if not bool(torch.isfinite(lv).all()):
        raise AssertionError("a citation2-like training loss is not finite")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")


def _snapshot(state):
    """Copies on the host of a training state's parameter leaves and
    optimizer state."""
    from lpformer_tpu_torch.train import optim

    return ([x.detach().to("cpu", copy=True)
             for x in optim.tree_leaves(state.params)],
            {k: v.to("cpu", copy=True) for k, v in state.opt_state.items()})


def _same_snapshot(a, b):
    return (len(a[0]) == len(b[0])
            and all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and sorted(a[1]) == sorted(b[1])
            and all(torch.equal(a[1][k], b[1][k]) for k in a[1]))


def phase_pubmed(dev, card, tabs):
    """Phase 10, the pubmed-like preset (presets.py: f32, classic table of
    C = 224, batch 1024, mask_input): its propagation layout must be the
    BucketedELL with slot edge ids; one training step through the kernels
    against the plain path (double propagation); train_loop for 2 epochs
    with the preset's dropouts, steps_per_call=4, grad_accum=2,
    save_every=1 and save_as, with rows 3-5 launched as the path's calls
    say; then a resume from <name>.latest.ckpt for epoch 3, which must
    start from the saved state bit for bit; then the timed steps."""
    import tempfile

    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.graph.containers import BucketedELL
    from lpformer_tpu_torch.train import step as step_mod, trainer
    from lpformer_tpu_torch.utils import checkpoint as ckpt
    from lpformer_tpu_torch.utils.logger import ResultsLogger

    cfg, batch = presets.PUBMED_LIKE_CONFIG, presets.PUBMED_LIKE_BATCH
    ds = load_dataset(dev, presets.PUBMED_LIKE_DATA)
    g = ds.graph
    log(f"pubmed-like layout: {type(g.ell).__name__}, "
        f"{None if g.ell is None else g.ell.slot_total} slots in "
        f"{None if g.ell is None else len(g.ell.caps)} tiers, slot edge ids "
        f"{g.ell is not None and g.ell.slot_edges is not None}, blk "
        f"{g.blk is not None}, bbell {g.bbell is not None}; edge_rank "
        f"{None if g.edge_rank is None else len(g.edge_rank)} of "
        f"{g.num_edges} edges; {_device_bytes(g) / 2**20:.1f} MiB on the "
        f"card")
    if not (isinstance(g.ell, BucketedELL) and g.ell.slot_edges is not None
            and g.blk is None and g.bbell is None and g.edge_rank is not None
            and len(g.edge_rank) == g.num_edges):
        raise AssertionError("the pubmed-like bundle must carry the "
                             "BucketedELL with slot edge ids and edge_rank")
    _step_pair(dev, ds, "classic", tabs, cfg, batch, mask_input=True)

    t, epochs, k, ga = tabs["classic"], 2, 4, 2
    steps = epochs * math.ceil(len(ds.train_pos) / batch)
    splits = [ds.train_pos_val, ds.valid_pos, ds.test_pos, ds.valid_neg,
              ds.test_neg]
    recorded = {}
    real_make = step_mod.make_train_step

    def spy(*a, **kw):
        fn = real_make(*a, **kw)

        def call(state, *rest):
            if "first" not in recorded:
                recorded["first"] = _snapshot(state)
            out = fn(state, *rest)
            recorded["last"] = out[0]
            return out
        return call

    with tempfile.TemporaryDirectory() as tmp:
        args = trainer.TrainArgs(
            epochs=epochs, batch_size=batch, eval_steps=1, seed=0,
            lr=presets.PUBMED_LIKE_LR, l2=presets.PUBMED_LIKE_L2,
            mask_input=True, steps_per_call=k, grad_accum=ga, save_every=1,
            save_as="pubmed-like", data_name="pubmed-like",
            checkpoint_dir=tmp, verbose=False)
        name = os.path.join(tmp, args.data_name, args.save_as)
        eval_batches = sum(-(-len(x) // args.test_batch_size)
                           for x in splits)
        loggers = {n: ResultsLogger(1) for n in
                   ("Hits@20", "Hits@50", "Hits@100", "MRR")}
        counters = _counters(tabs)
        for f in counters.values():
            f.launches = 0
        losses = []
        step_mod.make_train_step = spy
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer.train_loop(args, cfg, ds, loggers, 0, name,
                               step_losses=losses)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = {n: f.launches for n, f in counters.items()}
            saved_state = _snapshot(recorded.pop("last"))
            recorded.clear()
            files = sorted(os.listdir(os.path.dirname(name)))
            latest = name + ".latest.ckpt"
            on_disk = ckpt.load_checkpoint(latest)
            from_file = _snapshot(step_mod.TrainState(
                on_disk["params"], on_disk["opt_state"], 0))

            resumed = dataclasses.replace(args, epochs=epochs + 1,
                                          resume=latest)
            res_losses = []
            res_loggers = {n: ResultsLogger(1) for n in loggers}
            t0 = time.perf_counter()
            trainer.train_loop(resumed, cfg, ds, res_loggers, 0,
                               step_losses=res_losses)
            torch.cuda.synchronize()
            res_wall = time.perf_counter() - t0
        finally:
            step_mod.make_train_step = real_make
    want = dict.fromkeys(counters, 0)
    want[t["fwd_entry"][0]] = (2 * ga * steps
                               + eval_batches * epochs) * cfg.trans_layers
    want[t["bwd_entry"][0]] = 2 * ga * steps * cfg.trans_layers
    want["scatter_rows_add"] = 2 * ga * steps * cfg.trans_layers
    lv = torch.cat([x.reshape(-1) for x in losses]).cpu()
    live = lv[lv != 0]
    rv = torch.cat([x.reshape(-1) for x in res_losses]).cpu()
    res = {n: v.results[0][-1] for n, v in loggers.items()}
    log(f"train_loop pubmed-like (mask_input, steps_per_call {k}, grad_accum "
        f"{ga}): {epochs} epochs, {len(live)} steps of {batch} in "
        f"{len(losses)} calls, {wall:.1f} s wall incl. {epochs} "
        f"test_standard and checkpoints {files}; loss first "
        f"{float(live[0]):.4f} last {float(live[-1]):.4f}; " + ", ".join(
            f"{n} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}" for n, v in res.items())
        + f"; peak memory {peak:.2f} GiB; launches {launches} (want "
        f"{want})  [{card}]")
    if len(live) != steps or not bool(torch.isfinite(lv).all()):
        raise AssertionError("a pubmed-like training loss is not finite, or "
                             "a live step is missing")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for n, v in res.items():
        if not all(0.0 <= x <= 1.0 for x in v):
            raise AssertionError(f"{n} out of range: {v}")
    if files != ["pubmed-like.ckpt", "pubmed-like.latest.ckpt"]:
        raise AssertionError(f"checkpoint files {files}")
    first = recorded.get("first")
    ok_ = (first is not None and _same_snapshot(from_file, saved_state)
           and _same_snapshot(first, saved_state))
    res_epochs = len(res_loggers["MRR"].results[0])
    log(f"resume from {os.path.basename(latest)} (epoch "
        f"{int(on_disk['epoch'])}, step {int(on_disk['step'])}): params and "
        f"optimizer state equal to the saved ones bit for bit: {ok_}; "
        f"epoch {epochs + 1} alone ran ({len(rv[rv != 0])} steps, "
        f"{res_epochs} eval) in {res_wall:.1f} s wall incl. one "
        f"test_standard; losses finite {bool(torch.isfinite(rv).all())}")
    if not ok_ or int(on_disk["epoch"]) != epochs:
        raise AssertionError("the resumed state differs from the saved one")
    if (len(rv[rv != 0]) != steps // epochs or res_epochs != 1
            or not bool(torch.isfinite(rv).all())):
        raise AssertionError("the resumed run did not run epoch 3 alone")
    _timed_steps(dev, card, ds, "classic (pubmed-like, mask_input)", cfg,
                 batch, 10, mask_input=True)
    del ds
    torch.cuda.empty_cache()


def _timed_call(fn):
    """fn() with CUDA events and the peak memory: (result, ms, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1), torch.cuda.max_memory_allocated() / 2**30


def phase_ddi_remat(dev, card, ds, tabs):
    """Phase 11a, the ddi-like classic table (C = 768, O = dh = 256, bf16,
    dataset of the ddi-like preset): one training step where the auto
    rule turns the pairwise block's remat on, against remat_pairwise=False
    from the same generator seed with the dropouts on; row 4 launches
    twice a layer and a forward under remat."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.train import optim, step as step_mod

    cfg, batch = presets.DDI_LIKE_CLASSIC_CONFIG, presets.DDI_LIKE_BATCH
    c = sum(cfg.context.class_budgets)
    if not lt.remat_pairwise_on(cfg, batch, c):
        raise AssertionError("the auto rule must turn remat on here")
    t = tabs["classic"]
    pos = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    w = torch.ones(batch, device=dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)
    out = {}
    for remat in (True, False):
        rc = dataclasses.replace(cfg, remat_pairwise=remat)
        params = _fresh_params(dev, rc, int(ds.graph.x.shape[1]))
        leaves = optim.tree_leaves(params)

        def step():
            gen = torch.Generator(device=dev).manual_seed(3)
            neg = torch.randint(0, ds.num_nodes, (2, batch), generator=gen,
                                device=dev, dtype=pos.dtype)
            loss = step_mod.loss_fn(params, rc, ds.graph, pos[:, 0],
                                    pos[:, 1], neg[0], neg[1], w, mr, gen)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        step()   # warm-up
        t["op"].launches = 0
        (loss, grads), ms, peak = _timed_call(step)
        out[remat] = (loss, grads, ms, peak, t["op"].launches)
        del params, leaves
    paths = optim.tree_leaves_with_path(
        _fresh_params(dev, cfg, int(ds.graph.x.shape[1])))
    on, off = out[True], out[False]
    _compare_steps(f"ddi-like classic step (C {c}, dim {cfg.dim}, bf16, "
                   f"dropouts on) remat vs no remat", on[:2], off[:2], paths)
    log(f"ddi-like classic step: remat {on[2]:.3f} ms, peak {on[3]:.2f} GiB,"
        f" row 4 launches {on[4]}; no remat {off[2]:.3f} ms, peak "
        f"{off[3]:.2f} GiB, row 4 launches {off[4]}  [{card}]")
    if on[4] != 4 * cfg.trans_layers or off[4] != 2 * cfg.trans_layers:
        raise AssertionError("row 4 must launch once more a forward under "
                             "remat")


def _grad_accum_arm(dev, ds, tabs, cfg, batch, pos, w, bin_w, ga):
    """One make_train_step step at grad_accum ``ga`` on fresh parameters,
    timed after one warm-up step: (loss, the grads the optimizer received,
    ms, peak GiB, rows 1 / 2 launches of the timed step), and the leaves'
    paths."""
    from lpformer_tpu_torch.train import optim, step as step_mod

    t = tabs["combined"]
    opt = optim.make_optimizer(1e-3)
    seen = []

    def update(grads, state, p=None):
        seen.append([g.detach().clone() for g in optim.tree_leaves(grads)])
        return opt.update(grads, state, p)

    step = step_mod.make_train_step(
        cfg, optim.GradientTransformation(opt.init, update), grad_accum=ga)
    for _ in ("warm-up", "timed"):
        params = _fresh_params(dev, cfg, int(ds.graph.x.shape[1]))
        state = step_mod.TrainState(params, opt.init(params), 0)
        for f in (t["op"], t["bwd"]):
            f.launches = 0
        (state, loss), ms, peak = _timed_call(lambda: step(
            state, ds.graph, ds.mask_mult_device, bin_w, pos[:, 0],
            pos[:, 1], w, torch.Generator(device=dev).manual_seed(3)))
    return ((loss, seen[-1], ms, peak, t["op"].launches, t["bwd"].launches),
            optim.tree_leaves_with_path(params))


def phase_ddi_grad_accum(dev, card, ds, tabs):
    """Phase 11b, the ddi-like combined step (rows 1-3 at O = dh = 256):
    make_train_step with grad_accum=2 against 1, dropouts off, the same
    negatives, a padded tail of a quarter of the batch (zero weights, as a
    ragged last batch has them): the loss and the gradients the optimizer
    receives; both steps' ms and peak memory. Each pair runs through the
    kernels, held to the tolerances, and through the plain versions as a
    witness that is logged but not held. In bf16 each micro-batch's
    gradient of a bf16 weight copy is rounded before the sum, on both
    paths (STEP tolerances); in f32 the GEMMs' rounding at half the rows
    remains (STEP_F32_LOSS_TOL, STEP_F32_ACCUM_GRAD_TOL)."""
    from lpformer_tpu_torch import presets

    cfg = dataclasses.replace(presets.DDI_LIKE_CONFIG, dropout=0.0,
                              gnn_drop=0.0, att_drop=0.0)
    batch = presets.DDI_LIKE_BATCH
    pos = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    w = torch.ones(batch, device=dev)
    w[-(batch // 4):] = 0.0
    bin_w = (ds.graph.edge_w > 0).float()
    x = torch.randn(batch, 3 * cfg.dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    lin = torch.randn(cfg.dim, 3 * cfg.dim, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(6))
    half = (x @ lin.T)[:batch // 2] - x[:batch // 2] @ lin.T
    log(f"f32 GEMM [{batch // 2}, {3 * cfg.dim}] x [{3 * cfg.dim}, "
        f"{cfg.dim}] against the same rows of [{batch}, {3 * cfg.dim}]: "
        f"bit-equal {bool((half == 0).all())}, max |diff| "
        f"{float(half.abs().max()):.3e}")
    f32 = dataclasses.replace(cfg, matmul_dtype="float32")
    witness = (float("inf"), float("inf"))   # logged, not held
    for label, c, plain, tol in (
            ("bf16 kernels", cfg, False, (STEP_LOSS_TOL, STEP_GRAD_TOL)),
            ("bf16 plain, a witness", cfg, True, witness),
            ("f32 kernels", f32, False,
             (STEP_F32_LOSS_TOL, STEP_F32_ACCUM_GRAD_TOL)),
            ("f32 plain, a witness", f32, True, witness)):
        restore = _plain_training_path(tabs) if plain else (lambda: None)
        try:
            out = {}
            for ga in (2, 1):
                out[ga], paths = _grad_accum_arm(dev, ds, tabs, c, batch,
                                                 pos, w, bin_w, ga)
                torch.cuda.empty_cache()
        finally:
            restore()
        _compare_steps(f"ddi-like combined step (dim {c.dim}, batch {batch},"
                       f" {batch // 4} padded, {label}) grad_accum 2 vs 1",
                       out[2][:2], out[1][:2], paths, *tol)
        log(f"ddi-like grad_accum ({label}): 2 micro-batches "
            f"{out[2][2]:.3f} ms, peak {out[2][3]:.2f} GiB, rows 1/2 "
            f"launches {out[2][4]}/{out[2][5]}; monolithic {out[1][2]:.3f} "
            f"ms, peak {out[1][3]:.2f} GiB, rows 1/2 launches "
            f"{out[1][4]}/{out[1][5]}  [{card}]")
        for ga in (1, 2):
            want = (0 if plain else 2 * ga * c.trans_layers,) * 2
            if out[ga][4:] != want:
                raise AssertionError(f"grad_accum {ga} ({label}): launches "
                                     f"{out[ga][4:]}, not {want}")

# scripts/make_rehearsal_npz.py --scale of phase 12's npz by default (1.0:
# ogbl-collab's 235,868 nodes and 1,179,052 train collaborations, whose
# cold build of both PPRs took 340.6 s of the script's 1200; PERF.md §4)
REHEARSAL_SCALE = 0.5
# phase 13's Planetoid fixture at Cora's published sizes, with HeaRT's 500
# negatives a positive
CORA_NODES, CORA_FEATS, CORA_EDGES, CORA_HEART_NEGS = 2708, 1433, 5278, 500


class _Tee(io.TextIOBase):
    """Standard output that is also kept."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        return self.buf.write(s)

    def flush(self):
        self.out.flush()


def _cli(argv):
    """``lpformer_tpu_torch.cli.run.main(argv)``, its standard output echoed
    and kept: (result, output, wall s)."""
    from lpformer_tpu_torch.cli import run

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = run.main(argv)
    torch.cuda.synchronize()
    return result, tee.buf.getvalue(), time.perf_counter() - t0


def _printed_metrics(text):
    """{metric: (train, valid, test)} from the CLI's '  name = (...)'
    lines, as printed (Python float reprs: equal text, equal bits)."""
    return {m.group(1): tuple(float(x) for x in m.group(2).split(", "))
            for m in re.finditer(r"^  (\S+) = \((.*)\)$", text, re.M)}


def _printed(pattern, text, what):
    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"the CLI printed no {what}")
    return m.groups()


def _zeroed(tabs):
    counters = _counters(tabs)
    for f in counters.values():
        f.launches = 0
    return counters


def _check_launches(label, counters, want, card):
    launches = {n: f.launches for n, f in counters.items()}
    log(f"{label}: launches {launches} (predicted {want})  [{card}]")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")


def phase_graft_entry(dev, tabs):
    """graft_entry.entry(): the single-device forward at the JAX entry's
    tiny shapes, once: 64 finite probabilities through row 4."""
    from lpformer_tpu_torch import graft_entry

    counters = _zeroed(tabs)
    fn, args = graft_entry.entry()
    out = fn(*args)
    fwd = tabs["classic"]["fwd_entry"][0]
    log(f"graft_entry.entry(): scores {tuple(out.shape)} on "
        f"{out.device}, {counters[fwd].launches} launch(es) of {fwd}")
    if (out.shape != (64,) or out.device.type != "cuda"
            or not bool(((out > 0) & (out < 1)).all())
            or counters[fwd].launches != 1):
        raise AssertionError("graft_entry.entry() failed")


@contextlib.contextmanager
def _recording(module, name, sink):
    """``module.name`` replaced, inside the block, by a wrapper that
    appends each call's result to ``sink``."""
    real = getattr(module, name)

    def wrapper(*a, **kw):
        sink.append(real(*a, **kw))
        return sink[-1]

    setattr(module, name, wrapper)
    try:
        yield sink
    finally:
        setattr(module, name, real)


def _close_scores(label, a, b, card):
    """The eval scores of two runs (one array per score_edges call), each
    pair of the same shape and dtype and within CKPT_SCORE_TOL; logs how
    many there are, how many distinct values they take (scores that all
    saturated would prove little) and how many differ at all."""
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape for x, y in zip(a, b))
    diff = max((float(np.abs(x.astype(np.float64) - y).max())
                for x, y in zip(a, b) if x.size), default=0.0) if same else \
        math.inf
    n_diff = sum(int((x != y).sum()) for x, y in zip(a, b)) if same else -1
    flat = np.concatenate([x.ravel() for x in a]) if a else np.zeros(0)
    log(f"{label}: {len(a)} / {len(b)} score arrays, {flat.size} scores "
        f"({np.unique(flat).size} distinct, in [{flat.min():.6g}, "
        f"{flat.max():.6g}]); {n_diff} differ, max |diff| {diff:.3e} (tol "
        f"{CKPT_SCORE_TOL})  [{card}]")
    if not same or not diff <= CKPT_SCORE_TOL or not np.isfinite(flat).all():
        raise AssertionError(f"{label}: the scores differ")


def _bwd_check_sums(t, a, label):
    """Row 5 in f32 against its plain version on the backward inputs ``a``
    of the classic table, held as SUM_TOL's comment says; logs both
    measures (the weight grads' BWD_TOL-style errors against the plain
    version too, unheld) and the times."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = t["bwd"](**a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = in_link_chunks(t["bwd_plain"], a, 2)
    wit = in_link_chunks(measure.classic_bwd_f64, a, 0)
    tol, tol_mean = BWD_TOL[torch.float32]
    dkeys, n_kink = measure.kink_exempt(a, got[0], want[0], tol)
    per_link = {n: _rel_errs(x, y) for n, x, y in (
        ("dkeys", dkeys, want[0]), ("dq", got[1], want[1]),
        ("datt", got[7], want[7]))}
    ok_ = all(e[0] <= tol and e[1] <= tol_mean for e in per_link.values())
    sums, text = {}, []
    for n, x, p, ex, mag in zip(BWD_NAMES[2:7], got[2:7], want[2:7],
                                wit[:5], wit[5:]):
        err = (x.double() - ex).abs()
        perr = (p.double() - ex).abs()
        ok_ &= bool((err <= SUM_TOL * mag).all())
        sums[n] = (float((err / mag.clamp_min(1e-300)).max()),
                   float(err.mean() / mag.mean().clamp_min(1e-300)))
        ok_ &= sums[n][1] <= SUM_TOL_MEAN
        text.append(f"{n} {sums[n][0]:.2e}/{sums[n][1]:.2e} (plain "
                    f"{float((perr / mag.clamp_min(1e-300)).max()):.2e}/"
                    f"{float(perr.mean() / mag.mean()):.2e}; vs plain "
                    f"{_rel_errs(x, p)[0]:.2e}/{_rel_errs(x, p)[1]:.2e})")
    ok_ &= all(bool(torch.isfinite(x.float()).all()) for x in got)
    del got, want, wit, dkeys
    ms = time_ms(lambda: t["bwd"](**a), 3, per=2)
    plain_ms = time_ms(lambda: in_link_chunks(t["bwd_plain"], a, 2), 3, 1)
    bound, bound_by, nv = t["bwd_bound"](a)
    log(f"kernel bwd classic float32 {label} ({_shape(a)}): "
        + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in
                    per_link.items())
        + f" (max/mean rel err against plain, {n_kink} dkeys elements at "
        f"the kink held to the f64 witness; tol {tol}/{tol_mean}); weight "
        f"grads against their f64 sums, over the sums of their terms' "
        f"magnitudes (max/mean; tol {SUM_TOL}/{SUM_TOL_MEAN}): "
        + ", ".join(text) + f"; {nv} valid slots; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
    if not ok_:
        raise AssertionError(f"classic backward kernel at {label} "
                             f"disagrees with plain in f32")


def _hold_path_kernels(dev, tabs, label, cfg, args):
    """Rows 4-5 against their plain versions in f32 at a CLI path's class
    widths and O = dh = dim (the forward at the eval batch, the backward
    at the train batch, held by _bwd_check_sums), with
    collab_link_counts' spread in each block."""
    t = tabs["classic"]
    kw = dict(widths=tuple(cfg.context.class_budgets), o=cfg.dim,
              dh=cfg.dim)
    f32 = torch.float32
    a = t["inputs"](dev, f32, b=args.test_batch_size, **kw)
    _fwd_check("classic", t, a, f32, label, (3, 2))
    del a
    a = bwd_inputs(t["inputs"](dev, f32, b=args.batch_size, **kw))
    _bwd_check_sums(t, a, label)
    del a
    torch.cuda.empty_cache()


def _deterministic_ab(dev, card, ds, args, steps=7):
    """The A/B of torch's deterministic algorithms (what the JAX package's
    init_seed turns on, and the port's only on the CPU) on the CLI's own
    dataset and config: the timed step with the flag on and off, in turns
    on, off, off, on; the distinct warnings each arm raised; and, from
    three traced steps each way, the device kernels the flag adds, drops
    or launches a different number of times. The flag is put back as it
    was."""
    from lpformer_tpu_torch.cli import run

    cfg = run.build_config(args, ds)
    batch = args.batch_size
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    ms = {True: [], False: []}
    warned = {True: set(), False: set()}
    for flag in (True, False, False, True):
        torch.use_deterministic_algorithms(flag, warn_only=True)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            _, median = _timed_steps(
                dev, card, ds, f"classic (collab CLI, deterministic "
                f"{'on' if flag else 'off'})", cfg, batch, steps)
        ms[flag].append(median)
        warned[flag] |= {f"{w.category.__name__}: "
                         f"{str(w.message).splitlines()[0][:240]}"
                         for w in rec}
    kernels = {}
    for flag in (True, False):
        torch.use_deterministic_algorithms(flag, warn_only=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, busy, rows = measure.trace_device(
                lambda: _timed_steps(dev, card, ds, "traced", cfg, batch, 3),
                top=10**6)
        kernels[flag] = {name: (count, k_ms) for k_ms, count, name in rows}
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    log(f"init_seed A/B (collab CLI step, batch {batch}, median of "
        f"{steps - 2} steps a run): deterministic on {ms[True]} ms, off "
        f"{ms[False]} ms  [{card}]")
    for flag in (True, False):
        log(f"  warnings with the flag {'on' if flag else 'off'} "
            f"({len(warned[flag])} distinct): " + (" | ".join(
                sorted(warned[flag])) or "none"))
    on, off = kernels[True], kernels[False]
    diff = sorted(n for n in set(on) | set(off)
                  if on.get(n, (0,))[0] != off.get(n, (0,))[0])
    log(f"  device kernels whose launches the flag changes (3 steps, "
        f"on / off): {len(diff)}")
    for n in diff:
        a, b = on.get(n, (0, 0.0)), off.get(n, (0, 0.0))
        log(f"    {a[0]} / {b[0]} launches, {a[1]:.3f} / {b[1]:.3f} ms: "
            f"{n[:160]}")


def phase_cli_collab(dev, card, tabs, scale=REHEARSAL_SCALE,
                     deterministic_ab=False):
    """Phase 12: the CLI on the schema-exact collab npz that
    scripts/make_rehearsal_npz.py writes at ``scale``: ``--config
    ogbl-collab-existing`` for one run of one epoch with --save-as (the
    year filter, both PPRs, both bundles, measured budgets, f32 rows 3-5
    on the classic table), its launches as predicted from its calls, a
    finite loss, metrics in [0, 1] and both PPR cache files; then
    ``--checkpoint`` from the cache, whose metrics must equal the training
    run's bit for bit and its eval scores within CKPT_SCORE_TOL; then rows
    4-5 and one training
    step against their plain versions at the path's shapes on that
    dataset; with ``deterministic_ab`` the A/B of _deterministic_ab."""
    from lpformer_tpu_torch.cli import run
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models.config import LPFormerConfig
    from lpformer_tpu_torch.models.link_transformer import remat_pairwise_on

    t = tabs["classic"]
    root = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(
            root, "scripts", "make_rehearsal_npz.py"), "--out", data,
            "--scale", str(scale)], check=True, timeout=600)
        with np.load(os.path.join(data, "ogbl-collab.npz")) as z:
            n_train = int((z["train_year"] >= 2007).sum())
            eval_sizes = [len(z["valid_pos"]), len(z["valid_pos"]),
                          len(z["test_pos"]), len(z["valid_neg"]),
                          len(z["test_neg"])]
        log(f"phase 12: rehearsal npz (scale {scale}) written in "
            f"{time.perf_counter() - t0:.1f} s; {n_train} train links from "
            f"2007 on")
        argv = ["--config", "ogbl-collab-existing", "--data-dir", data,
                "--runs", "1", "--epochs", "1", "--save-as", "smoke",
                "--checkpoint-dir", ck]
        args = run.apply_config(run.build_parser(), argv)
        os.chdir(tmp)  # the readers' PPR cache: node_subsets/ppr/<name>/
        try:
            counters = _zeroed(tabs)
            torch.cuda.reset_peak_memory_stats()
            with _recording(harness, "score_edges", []) as trained_scores:
                _, out, wall = _cli(argv)
            peak = torch.cuda.max_memory_allocated() / 2**30
            build_s = float(_printed(r"read and built in ([\d.]+) s", out,
                                     "build time")[0])
            budgets = tuple(int(x) for x in _printed(
                r"cn=(\d+) onehop=(\d+) non1hop=(\d+)", out, "budgets"))
            loss, epoch_s = _printed(r"Epoch 1 Loss: (\S+) \(([\d.]+)s\)",
                                     out, "epoch loss")
            steps = -(-n_train // args.batch_size)
            remat = remat_pairwise_on(LPFormerConfig(dim=args.dim),
                                      args.batch_size, sum(budgets))
            eval_batches = sum(-(-m // args.test_batch_size)
                               for m in eval_sizes)
            log(f"phase 12 train: host build {build_s} s (both PPRs, both "
                f"bundles), budgets {budgets} (C = {sum(budgets)}), remat "
                f"{'on' if remat else 'off'} (B*C*dim*4 = "
                f"{args.batch_size * sum(budgets) * args.dim * 4:.3e}), "
                f"epoch {epoch_s} s for {steps} steps of "
                f"{args.batch_size}, loss {loss}, main() {wall:.1f} s, peak "
                f"memory {peak:.2f} GiB  [{card}]")
            want = dict.fromkeys(counters, 0)
            want[t["fwd_entry"][0]] = ((2 + 2 * remat) * steps
                                       + eval_batches) * args.tlayers
            want[t["bwd_entry"][0]] = 2 * steps * args.tlayers
            want["scatter_rows_add"] = 2 * steps * args.tlayers
            _check_launches("phase 12 train", counters, want, card)
            trained = _printed_metrics(out)
            cache = sorted(os.listdir(os.path.join(
                tmp, "node_subsets", "ppr", args.data_name)))
            log(f"phase 12 PPR cache: {cache}")
            if not math.isfinite(float(loss)):
                raise AssertionError(f"phase 12 loss {loss}")
            if cache != ["sparse_adj-015_eps-5e-05.npz",
                         "sparse_adj-015_eps-5e-05_val.npz"]:
                raise AssertionError(f"phase 12 PPR cache files {cache}")
            if list(trained) != [args.metric or run.default_metric(args)]:
                raise AssertionError(f"phase 12 metrics {trained}")

            counters = _zeroed(tabs)
            with _recording(run, "load_dataset", []) as kept, _recording(
                    harness, "score_edges", []) as evaluated_scores:
                res, out, wall = _cli(argv + ["--checkpoint", "smoke"])
            build_s = float(_printed(r"read and built in ([\d.]+) s", out,
                                     "build time")[0])
            evaluated = _printed_metrics(out)
            name = list(trained)[0]
            log(f"phase 12 --checkpoint: host build from the PPR cache "
                f"{build_s} s, main() {wall:.1f} s; {name} trained "
                f"{trained[name]}, evaluated {evaluated.get(name)}  [{card}]")
            want = dict.fromkeys(counters, 0)
            want[t["fwd_entry"][0]] = eval_batches * args.tlayers
            _check_launches("phase 12 --checkpoint", counters, want, card)
            if evaluated.get(name) != trained[name] or res != [
                    trained[name][2]]:
                raise AssertionError("phase 12: the checkpoint's metrics "
                                     "differ from the training run's")
            for k, v in evaluated.items():
                if not all(0.0 <= x <= 1.0 for x in v):
                    raise AssertionError(f"{k} out of range: {v}")
            _close_scores("phase 12 --checkpoint eval scores against the "
                          "training run's", evaluated_scores, trained_scores,
                          card)
            del trained_scores, evaluated_scores
            ds = kept.pop()
            cfg = run.build_config(args, ds)
            _hold_path_kernels(dev, tabs, "collab CLI", cfg, args)
            _step_pair(dev, ds, "classic (collab CLI)", tabs, cfg,
                       args.batch_size)
            if deterministic_ab:
                _deterministic_ab(dev, card, ds, args)
            del ds
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()


def _write_cora_like(root, seed=0):
    """A Planetoid directory ``cora`` at Cora's published sizes (2,708
    nodes, 1,433 binary features at Cora's ~1.3% density, 5,278 edges in
    an 85/5/10 split; a perfect matching covers every node and power-law
    draws give the rest), plain negatives as many as the positives, and
    HeaRT's [P, 500, 2] negatives (each positive's source against 500
    random targets). Returns the split sizes."""
    rng = np.random.default_rng(seed)
    n = CORA_NODES
    match = rng.permutation(n).reshape(-1, 2)
    p = np.arange(1, n + 1, dtype=np.float64) ** -0.8
    extra = rng.choice(n, size=(3 * CORA_EDGES, 2), p=p / p.sum())
    extra = extra[extra[:, 0] != extra[:, 1]][:CORA_EDGES - len(match)]
    edges = rng.permutation(np.concatenate([match, extra]))
    n_tr, n_va = round(0.85 * CORA_EDGES), round(0.05 * CORA_EDGES)
    splits = {"train_pos": edges[:n_tr], "valid_pos": edges[n_tr:n_tr + n_va],
              "test_pos": edges[n_tr + n_va:]}
    splits["valid_neg"] = rng.integers(0, n, (n_va, 2))
    splits["test_neg"] = rng.integers(0, n, (len(splits["test_pos"]), 2))
    d = os.path.join(root, "cora")
    os.makedirs(d)
    for name, arr in splits.items():
        with open(os.path.join(d, f"{name}.txt"), "w") as f:
            f.writelines(f"{a}\t{b}\n" for a, b in arr)
    feats = (rng.random((n, CORA_FEATS)) < 0.0127).astype(np.float32)
    torch.save({"entity_embedding": torch.from_numpy(feats)},
               os.path.join(d, "gnn_feature"))
    hd = os.path.join(root, "heart", "cora")
    os.makedirs(hd)
    for split in ("valid", "test"):
        pos = splits[f"{split}_pos"]
        neg = np.stack([np.repeat(pos[:, :1], CORA_HEART_NEGS, 1),
                        rng.integers(0, n, (len(pos), CORA_HEART_NEGS))], -1)
        np.save(os.path.join(hd, f"heart_{split}_samples.npy"), neg)
    return {k: len(v) for k, v in splits.items()}


def phase_cli_cora_heart(dev, card, tabs):
    """Phase 13: ``--config cora-heart`` through the CLI for one run of one
    epoch with one eval (--eval_steps 1; the config's 5 would leave one
    epoch unevaluated) on a Cora-sized Planetoid + HeaRT fixture
    (_write_cora_like): dim 256, 1 GCN layer without LayerNorm and ReLU,
    eps 1e-7, rows 3-5 at dh = 256 in f32; the HeaRT MRR in [0, 1] and
    the launches as predicted; then rows 4-5 and one training step
    against their plain versions at the path's shapes, as phase 12."""
    from lpformer_tpu_torch.cli import run

    t = tabs["classic"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        sizes = _write_cora_like(data)
        argv = ["--config", "cora-heart", "--data-dir", data, "--runs", "1",
                "--epochs", "1", "--eval_steps", "1"]
        args = run.apply_config(run.build_parser(), argv)
        os.chdir(tmp)
        try:
            counters = _zeroed(tabs)
            torch.cuda.reset_peak_memory_stats()
            with _recording(run, "load_dataset", []) as kept:
                _, out, wall = _cli(argv)
        finally:
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated() / 2**30
    budgets = tuple(int(x) for x in _printed(
        r"cn=(\d+) onehop=(\d+) non1hop=(\d+)", out, "budgets"))
    steps = -(-sizes["train_pos"] // args.batch_size)
    n_va, n_te = sizes["valid_pos"], sizes["test_pos"]
    eval_batches = sum(-(-m // args.test_batch_size) for m in (
        n_va, n_va, n_te, n_va * CORA_HEART_NEGS, n_te * CORA_HEART_NEGS))
    metrics = _printed_metrics(out)
    log(f"phase 13 (cora-heart): splits {sizes}, budgets {budgets}, "
        f"{steps} steps of {args.batch_size}, {eval_batches} eval batches "
        f"of {args.test_batch_size}; main() {wall:.1f} s, peak memory "
        f"{peak:.2f} GiB; {metrics}  [{card}]")
    want = dict.fromkeys(counters, 0)
    want[t["fwd_entry"][0]] = (2 * steps + eval_batches) * args.tlayers
    want[t["bwd_entry"][0]] = 2 * steps * args.tlayers
    want["scatter_rows_add"] = 2 * steps * args.tlayers
    _check_launches("phase 13", counters, want, card)
    if list(metrics) != ["MRR"] or not all(
            0.0 <= x <= 1.0 for x in metrics["MRR"]):
        raise AssertionError(f"phase 13 metrics {metrics}")
    ds = kept.pop()
    cfg = run.build_config(args, ds)
    _hold_path_kernels(dev, tabs, "cora-heart CLI", cfg, args)
    _step_pair(dev, ds, "classic (cora-heart CLI)", tabs, cfg,
               args.batch_size)
    del ds
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--collab-scale", type=float, default=REHEARSAL_SCALE,
                    help="scripts/make_rehearsal_npz.py --scale of phase "
                    "12's npz (1.0: ogbl-collab's size)")
    ap.add_argument("--deterministic-ab", action="store_true",
                    help="time phase 12's step with torch's deterministic "
                    "algorithms on and off, and trace what they swap")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from lpformer_tpu_torch import presets

    # the lookup route is chosen here, per phase, not by the caller's shell
    os.environ.pop(FUSED_LOOKUP, None)
    dev = torch.device("cuda")
    card = card_line()
    log(f"device: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    def stamp(what):
        log(f"{what}: done {time.perf_counter() - t_start:.1f} s after the "
            f"build began")

    phase_build()
    stamp("build")
    tabs = tables()
    # each kernel's entry, and the path whose run counts it
    entries = []
    for layout in tabs:
        entries.append((phase_kernel(dev, layout, tabs[layout]), layout))
        stamp(f"{layout} forward kernel checks")
        entries.append((phase_kernel_bwd(dev, layout, tabs[layout]), layout))
        stamp(f"{layout} backward kernel checks")
        if layout == "combined":
            entries.append((phase_scatter(dev, card), layout))
    entries += [(e, "attention A/B") for e in phase_link_attention(dev)]
    stamp("per-link attention kernel checks")
    torch.cuda.empty_cache()
    batch = presets.COLLAB_LIKE_BATCH
    ds = load_dataset(dev)
    entries.append((phase_lookup(dev, ds, tabs["combined"]["cfg"], batch),
                    "lookup route"))
    stamp("fused lookup kernel")
    launches = {}
    for layout in tabs:
        phase_main(dev, card, ds, layout, tabs[layout])
        launches[layout] = phase_train(dev, card, ds, layout, tabs)
        stamp(f"collab-like {layout} path")
    launches["lookup route"] = {"fused_lookup": phase_lookup_route(
        dev, card, ds, tabs, batch)}
    launches["attention A/B"] = phase_attention_ab(dev, card)
    stamp("lookup route and attention A/B")
    del ds
    torch.cuda.empty_cache()

    # the ddi-like preset: dim 256 on the combined table (rows 1-3)
    ds = load_dataset(dev, presets.DDI_LIKE_DATA)
    phase_main(dev, card, ds, "combined", tabs["combined"],
               cfg=presets.DDI_LIKE_CONFIG, batch=presets.DDI_LIKE_BATCH)
    phase_train(dev, card, ds, "combined", tabs, cfg=presets.DDI_LIKE_CONFIG,
                batch=presets.DDI_LIKE_BATCH)
    stamp("ddi-like path")
    torch.cuda.empty_cache()
    phase_ddi_remat(dev, card, ds, tabs)
    torch.cuda.empty_cache()
    phase_ddi_grad_accum(dev, card, ds, tabs)
    stamp("ddi-like classic remat and grad_accum (phase 11)")
    del ds
    torch.cuda.empty_cache()

    phase_heart(dev, card, tabs)
    stamp("HeaRT sweep")
    torch.cuda.empty_cache()

    phase_pubmed(dev, card, tabs)
    stamp("pubmed-like path (phase 10)")

    # the citation2-like preset: 1M nodes on the BlockedBELL, dim 64,
    # batch 32768, the combined table of 96 (rows 1-3)
    cfg, batch = presets.CITATION2_LIKE_CONFIG, presets.CITATION2_LIKE_BATCH
    ds = phase_citation2_build(dev)
    stamp("citation2-like build")
    phase_citation2_spmm(dev, card, ds, cfg.dim, batch)
    phase_citation2_kernels(dev, card, tabs, cfg, batch, ds.num_nodes + 1)
    stamp("citation2-like SpMM and kernel checks")
    phase_citation2_train(dev, card, ds, tabs, cfg, batch)
    stamp("citation2-like training")
    phase_citation2_eval(dev, card, ds, tabs, cfg, batch)
    stamp("citation2-like eval")
    del ds
    torch.cuda.empty_cache()

    phase_graft_entry(dev, tabs)
    phase_cli_collab(dev, card, tabs, opts.collab_scale,
                     opts.deterministic_ab)
    stamp("the CLI on the collab-scale npz (phase 12)")
    phase_cli_cora_heart(dev, card, tabs)
    stamp("the CLI on a Cora-sized HeaRT fixture (phase 13)")

    for e, path in entries:
        e["launches"] = launches[path][e["name"]]
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} never ran on the main path")
    entries = [e for e, _ in entries]
    log("kernels: " + "; ".join(
        f"{e['name']} ({e['route']}) launches {e['launches']}, max abs err "
        f"{e['max_abs_err']:.3e}, kernel_ms {e['ms']:.4f}, plain_ms "
        f"{e['plain_ms']:.4f}, bound_ms {e['bound_ms']:.5f} ({e['bound_by']})"
        + ("" if e["library_ms"] is None
           else f", library_ms {e['library_ms']:.4f}")
        for e in entries) + f"  [{card}]; "
        f"{time.perf_counter() - t_start:.1f} s from build to here")
    log(json.dumps({"kernels": entries}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
