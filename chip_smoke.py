"""Smoke run of the PyTorch/CUDA port (lpformer_tpu_torch) on one H100.

    python3 chip_smoke.py [--collab-scale S] [--deterministic-ab]
                          [--ppa-only]

With no arguments phase 12 reads the collab npz at REHEARSAL_SCALE;
``--collab-scale 1.0`` reads it at ogbl-collab's full size, and
``--deterministic-ab`` adds phase 12's A/B of torch's deterministic
algorithms. ``--ppa-only`` runs the build and phase 16 alone, and prints
no ok line. ``python -m lpformer_tpu_torch.profile_kernels --key-rows``
runs phase 17's report alone.

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
 17. keys by id: rows 1, 2, 4 and 5 fed their keys as a node table and
     the context ids (``KeyRows``, the model's fused route; dead slots on
     the pad id N, past the table) against the same wrappers fed the
     table ``gather_rows_valid`` gathers, at the main shape (bf16, f32)
     and at the citation2-like [32768, 448, 64] f32: m, l and dkeys bit
     for bit, out and the summed grads within their f32 atomics'
     reordering, one launch a call, no host synchronisation, and each
     wrapper's time both ways beside the gather's
     (``profile_kernels.key_rows_report``);
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
and, on the collab-like dataset, the dense attention route:
 14. (a) for each table layout, use_pallas_attention=False: one step's
     loss and gradients and one eval batch's scores against the kernel
     route in f32 (STEP_F32_LOSS_TOL, STEP_F32_ROUTE_GRAD_TOL and
     TOL[f32]), the bf16 step against itself
     with row 3 plain (STEP_*), the bf16 gap to the kernel route logged;
     an eval batch and 5 timed steps of each route (row 3 twice a step,
     rows 1, 2, 4, 5 never, on the dense runs), with peak memory; (b)
     num_heads=2 on the combined table (H*O 256): a step against plain row
     3, 5 timed steps and the eval sweep with the trained parameters; (c)
     test_by_cn_bins over the test split, the bins' counts adding up;
 15. the mesh (parallel/), on the collab-like dataset, whose PPR the
     parent caches for the ranks: (a) 4 ranks as a 2 x 2 mesh, every
     rank on this card over gloo (NCCL puts one rank on a card): the
     sharded loss and global gradient of one step, dropout off, against
     the single-device step over the same COO GCN with the batch split
     as the ranks split it, for the combined table plain,
     context-parallel (C over g = 2, held to the dense route, whose slice
     it is) and mask_input and the classic table, each in f32 (loss and
     every leaf held) and in bf16 (the loss, the median leaf, every leaf
     and the GCN's leaves held: MESH_BF16_*), every rank's launches equal
     to the single-device step's; 8 steps with the dropouts (the loss
     falls, the parameters bit-identical on every rank; ms and peak
     memory per rank, which are not a 4-card mesh's); the eval sweep
     through ShardedEvalContext, its scores held to the single-device
     scores (TOL[bf16]) and its launches counted; (b) one rank over NCCL
     (a 1 x 1 mesh): the plain steps held alike, NCCL's collectives
     checked on the card, then the CLI, ``--mesh 1,1`` on a small
     collab-like synthetic graph (MESH_CLI): one epoch with --save-as and
     the checkpoint's eval with ``--mesh 1,1``, their launches equal to
     the single-device CLI's, the checkpoint's eval scores held to the
     single-device CLI's eval of it (TOL[bf16]); (c)
     graft_entry.dryrun_multichip(8) on this card over gloo: the JAX
     dryrun's meshes (1,8), (2,4), (4,2), (8,1), each variant's loss equal
     to the single-device loss;
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
 16. the ppa-like preset (presets.py: 576,000 nodes, 15,000,000 train
     edges, dim 64, batch 32768, the combined table of 96, the residual
     GCN; 1,000,000 uniform negative pairs a split,
     measure.ppa_like_dataset): (a) the cold host build (no PPR cache),
     whose propagation layout must be the BlockedBELL of kb = 5 and no ELL;
     (b) one GCN layer's SpMM at [576k, 64] against a single BucketedELL
     and a static BlockedCOO (SPMM_TOL), its tier sweeps counted; (c) rows
     1-3 on the inputs the preset's own training batch gives them
     (measure.recording_kernel_inputs: the positive and the negative half,
     bf16) against their plain versions, row 2's per-class weight grads
     also against their sums in f64 (SUM_TOL); (d) the residual step pair in
     bf16 and in f32 (STEP_* and STEP_F32_*), then 8 steps with the
     default dropouts, rows 1-3 launched once per call and no other
     kernel; (e) the classic table's step pair (64 | 128 | 128) with the
     pairwise block's remat on by the rule, rows 4 / 5 / 3 launched 4 / 2
     / 2 times; (f) run_eval -> test_standard at batch 32768 over every
     split: scores finite, Hits@20/50/100 in [0, 1], row 1 launched once
     per score batch, one batch against the plain path;
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
 13. ``--config cora-heart --runs 1 --epochs 1 --eval_steps 1 --save-as
     --dump-att`` on a Planetoid + HeaRT fixture at Cora's published
     sizes: rows 3-5 at dh = 256 in f32, the MRR in [0, 1], the launches
     as predicted; the dump's dense-route call launching none of rows
     1-5, and attention_weights.npz well formed; then rows 4-5 and one
     step against their plain versions as in phase 12;
then a "kernels:" summary line and a JSON line of per-kernel numbers (each
kernel's launches from its path's run: rows 1-3 the collab-like combined
train_loop, rows 4-5 the classic one, rows 6-7 phase 7, row 8 phase 6),
the card line again, and as the last line {"ok": true, "device": {...}}.
Any failure exits nonzero before that line. Nothing here imports JAX.
Whether it passes or fails, the script leaves no process running: it
adopts its descendants' orphans and, at its end, stops and reaps every
child still alive, naming each on stderr.
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
import shutil
import signal
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
# The dense attention route against the kernel route in f32 (phase 14),
# per leaf: both compute the same function, but not with the same f32
# roundings (the dense route adds the PE and the node keys in another
# order, so its h lies ulps away from the kernel route's everywhere), and
# a ReLU whose input lies within rounding of 0 (score head, pairwise MLP,
# GCN) takes the other slope on one side: one such flip moves every leaf
# upstream of it. At the collab-like step the dense route reads 1.30e-4
# against the kernel route and 1.38e-4 against an f64 run of itself
# (the kernel route 9.4e-5), while the two routes' f32 scores agree to
# 1.2e-7 (PERF.md §6, phase 14). A wrong route (a lost PE term or bias,
# heads mixed up) moves leaves by 1e-2 or more, and the route's scores
# are held to TOL[f32].
STEP_F32_ROUTE_GRAD_TOL = 1e-3
# grad_accum 2 against 1 in f32 (the ddi-like combined step), per leaf:
# the micro-batches' GEMMs take half the rows, and cuBLAS rounds a row of
# an [M/2, K] product otherwise than the same row of the [M, K] one (the
# phase logs by how much). The leaves whose gradient cancels across a
# link's slots (att_layers/0/att, lin_l: |g| ~1e-6 against 1e-2 to 1
# elsewhere) carry that rounding at ~6e-4 through the plain versions as
# through the kernels (PERF.md §6); a wrong denominator or a lost
# micro-batch moves every leaf by O(1e-1).
STEP_F32_ACCUM_GRAD_TOL = 2e-3
# Phase 15's bf16 mesh steps against the single-device step over the same
# COO GCN, the batch split as the ranks split it, per leaf ||a - b|| /
# ||b||. The two still add each node's messages in another order (the
# rank's edge block, then the psum over 'data'), and a last-bit change of
# an f32 sum before its bf16 rounding flips it. At the PE encoders' and
# the attention's weights, whose gradients are small sums that cancel
# over the slots, such flips move a leaf by 1e-2 to 2e-1 between two
# single-device steps of the same math (PERF.md §6: the batch split 4
# ways 1.2e-2 to 1.9e-2, the COO GCN against the BucketedELL 4.0e-2, the
# dense route against the kernels 1.8e-1), while the median leaf stays
# at 1.3e-3 to 1.9e-3 (the mesh against the BucketedELL). So the median
# is held to 1e-2, every leaf to 0.25, and the GCN's leaves
# (node_encoder, gnn_norm: what the sharded SpMM's bf16 gather feeds)
# to STEP_GRAD_TOL: a leaf that lost the shares of one to three of the
# four ranks, or counted one twice, moves by about 0.25 or more, and a
# lost all-reduce moves every leaf.
MESH_BF16_MEDIAN_TOL, MESH_BF16_LEAF_TOL = 1e-2, 0.25
MESH_BF16_GCN = ("node_encoder", "gnn_norm")
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
# (measure.kink_exempt); dq and datt hold BWD_TOL. Phase 16 holds row 2's
# per-class sums (dw1cat, dg, db, dcb) on the ppa-like training batch's
# tables the same way (measure.mixed_bwd_f64).
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


# prctl option: orphaned descendants are re-parented to this process
PR_SET_CHILD_SUBREAPER = 36


def _adopt_orphans():
    """Make this process the reaper of its descendants' orphans (Linux), so
    every process the run starts, however deep, is its child by the time
    :func:`_stop_children` looks."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _child_pids() -> list:
    """This process's children, (pid, command line), read from /proc."""
    me, kids = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == me:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(
                        errors="replace").strip()
                kids.append((int(d), cmd))
        except (OSError, ValueError, IndexError):
            continue
    return kids


def _stop_children():
    """Stop and reap every process of this run still alive at its end:
    multiprocessing's resource tracker (phase 15's ranks start it), then
    any other child or adopted orphan, SIGTERM and after 5 s SIGKILL. Each
    one is named on stderr, which leaves the last line of stdout alone."""
    from lpformer_tpu_torch.parallel import distributed

    distributed.stop_resource_tracker()
    for _ in range(8):
        kids = _child_pids()
        if not kids:
            return
        for pid, cmd in kids:
            print(f"chip_smoke: stopping process {pid} left running: {cmd}",
                  file=sys.stderr, flush=True)
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        live = {pid for pid, _ in kids}
        deadline = time.monotonic() + 5.0
        while live:
            for pid in list(live):
                try:
                    if os.waitpid(pid, os.WNOHANG)[0]:
                        live.discard(pid)
                except ChildProcessError:
                    live.discard(pid)
            if live and time.monotonic() > deadline:
                for pid in live:
                    try:
                        os.kill(pid, signal.SIGKILL)
                        os.waitpid(pid, 0)
                    except (ProcessLookupError, ChildProcessError):
                        pass
                live = set()
            time.sleep(0.05)


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
            plain_op=lambda keys, *a: pam.MixedOp.apply(
                pam.fused_pe_link_attention_mixed_plain,
                pam.fused_pe_link_attention_mixed_bwd_plain,
                *pam.key_parts(keys), *a),
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
            plain_op=lambda keys, *a, class_widths: pa.BlockedOp.apply(
                pa.fused_pe_link_attention_plain,
                pa.fused_pe_link_attention_bwd_plain, tuple(class_widths),
                *pam.key_parts(keys), *a),
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


def phase_key_rows(dev, card):
    """Phase 17: the PE+attention wrappers fed their keys by id against
    the gathered table (raises on a disagreement)."""
    from lpformer_tpu_torch.profile_kernels import key_rows_report

    key_rows_report(card, dev, log=log)
    torch.cuda.empty_cache()


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


def load_dataset(dev, data=None, ppr_cache_dir=None):
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.data.synthetic import synthetic_dataset

    data = data or presets.COLLAB_LIKE_DATA
    t0 = time.perf_counter()
    ds = synthetic_dataset(**data, ppr_cache_dir=ppr_cache_dir, device=dev)
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
            f"rest {total_ms - ctx_ms - kern_ms:.3f} (key projection, MLPs); "
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
                   grad_tol=STEP_GRAD_TOL, hold=True):
    """(loss, grads) of step ``a`` against step ``b``: the loss's |diff|
    and every leaf's ||a - b|| / ||b|| within the tolerances, a's grads
    finite (with ``hold`` False: logged only); logs one line and returns
    (bit-equal, loss |diff|, the largest leaf error)."""
    dl = abs(float(a[0]) - float(b[0]))
    rel = [float((x - y).norm() / y.norm().clamp_min(1e-30))
           for x, y in zip(a[1], b[1])]
    worst = leaves_with_path[rel.index(max(rel))][0]
    equal = bool(torch.equal(a[0], b[0])) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    log(f"{label}: loss {float(a[0]):.6f} vs {float(b[0]):.6f} (|diff| "
        f"{dl:.2e}, tol {loss_tol if hold else 'none'}); grad leaves "
        f"{len(rel)}, max rel L2 err {max(rel):.2e} at "
        f"{'/'.join(map(str, worst))} (median {statistics.median(rel):.2e}, "
        f"tol {grad_tol if hold else 'none'}); bit-equal {equal}")
    if hold and (dl > loss_tol or max(rel) > grad_tol or not all(
            bool(torch.isfinite(x).all()) for x in a[1])):
        raise AssertionError(f"{label} disagree")
    return equal, dl, max(rel)


def _nodrop(c):
    return dataclasses.replace(c, dropout=0.0, gnn_drop=0.0, att_drop=0.0,
                               feat_drop=0.0, pred_drop=0.0)


def _step_inputs(ds, batch, dev):
    """The held steps' batch: the first ``batch`` train links, negatives
    from a fixed seed, unit weights (the same on every rank of phase 15)."""
    pos = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    neg = torch.randint(0, ds.num_nodes, (2, batch),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    return pos, neg, torch.ones(batch, device=dev)


def _step_pair(dev, ds, layout, tabs, cfg, batch, mask_input=False,
               against=None, hold=True):
    """One training step, dropout off and fixed negatives, through the
    kernels and through the plain versions: the loss and every gradient
    leaf must agree (STEP_LOSS_TOL, STEP_GRAD_TOL; in f32 the STEP_F32
    pair). With ``mask_input`` the step propagates twice, the positive
    half over the batch-masked weights. With ``against`` (a config of the
    same parameters, e.g. the other attention route) the second step runs
    that config through the kernels instead; with ``hold`` False the pair
    is logged and not held. Returns _compare_steps' result."""
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.train import optim, step as step_mod

    params = _fresh_params(dev, _nodrop(cfg), int(ds.graph.x.shape[1]))
    leaves = optim.tree_leaves(params)
    pos, neg, w = _step_inputs(ds, batch, dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)
    prop_w = (masking.mask_edge_weights(mr, ds.graph.edge_rank,
                                        (ds.graph.edge_w > 0).float())
              if mask_input else None)

    def loss_and_grads(c):
        loss = step_mod.loss_fn(params, _nodrop(c), ds.graph, pos[:, 0],
                                pos[:, 1], neg[0], neg[1], w, mr, None,
                                prop_w, mask_input)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads(cfg)
    if against is None:
        restore = _plain_training_path(tabs)
        try:
            loss_p, grads_p = loss_and_grads(cfg)
        finally:
            restore()
        what = "kernels vs plain"
    else:
        loss_p, grads_p = loss_and_grads(against)
        what = "vs the same step through the kernel route"
    return _compare_steps(
        f"train step {layout} (dim {cfg.dim}, batch {batch}, "
        f"{cfg.matmul_dtype}{', mask_input' if mask_input else ''}) {what}",
        (loss_k, grads_k), (loss_p, grads_p),
        optim.tree_leaves_with_path(params),
        *((STEP_LOSS_TOL, STEP_GRAD_TOL) if cfg.mm_dtype
          else (STEP_F32_LOSS_TOL, STEP_F32_GRAD_TOL)), hold=hold)


def _timed_steps(dev, card, ds, layout, cfg, batch, steps, skip=2,
                 mask_input=False, stats=None):
    """``steps`` training steps with the preset's dropouts through the
    functions train_loop's step runs (masking, loss_fn, backward, the
    fused optimizer; with ``mask_input`` the masked propagation weights
    and two propagations), CUDA events around the forward, backward and
    optimizer; logs the medians over the steps after the first ``skip``
    and the peak memory, and returns (every step's loss, the median step
    ms); ``stats``, a dict, gets the medians, the peak (GiB) and the
    trained parameters too."""
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
    if stats is not None:
        stats.update(forward=fwd, backward=bwd, optimizer=upd_ms, step=total,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     params=params)
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


def _big_build(label, make, kb):
    """A big preset's dataset from ``make()``, timed: its propagation
    layout must be the BlockedBELL of ``kb`` x ``kb`` tiles, and no ELL;
    logs the build, the layout and the bundle's device memory."""
    t0 = time.perf_counter()
    ds = make()
    g = ds.graph
    log(f"{label} dataset: {time.perf_counter() - t0:.1f} s host "
        f"build ({ds.num_nodes} nodes, {g.num_edges} directed edges); "
        f"layout {'bbell' if g.bbell is not None else 'none'} kb "
        f"{None if g.bbell is None else g.bbell.kb}, "
        f"{None if g.bbell is None else g.bbell.slot_total} slots in "
        f"{0 if g.bbell is None else sum(x is not None for x in g.bbell.tiles)}"
        f" tiles, ell {g.ell is not None}, blk {g.blk is not None}; the "
        f"bundle holds {_device_bytes(g) / 2**30:.2f} GiB on the card")
    if g.bbell is None or g.bbell.kb != kb or g.ell is not None:
        raise AssertionError(f"the {label} bundle must carry the "
                             f"BlockedBELL with kb = {kb} and no ELL")
    return ds


def phase_citation2_build(dev):
    """The citation2-like preset's dataset (measure.citation2_like_dataset:
    1,000,000 nodes, 5,000,000 train edges, 1000 negative targets per eval
    positive): its propagation layout must be the BlockedBELL of 8 x 8
    tiles, and no ELL."""
    return _big_build("citation2-like",
                      lambda: measure.citation2_like_dataset(dev), 8)


def _counting_tier_sweeps(fn):
    """``fn()`` with ops/spmm.py's tier sweeps counted: (its result, the
    sweeps, their slot-chunk gathers)."""
    from lpformer_tpu_torch.ops import spmm

    real, chunks = spmm._tier_sweep, []

    def counted(nb, ws, xg, out_dtype, kc):
        chunks.append(-(-nb.shape[1] // kc))
        return real(nb, ws, xg, out_dtype, kc)

    spmm._tier_sweep = counted
    try:
        return fn(), len(chunks), sum(chunks)
    finally:
        spmm._tier_sweep = real


def phase_big_spmm(dev, card, ds, dim, batch, masked=True):
    """One GCN layer's SpMM on a big preset's graph at [N, dim], f32 and
    with bf16 gather, through spmm_bbell, against a single BucketedELL and
    a static BlockedCOO built over the same graph for this check only (an
    A/B of the layouts; the layout rule stays the JAX package's), with the
    BlockedBELL layer's tier sweeps counted. Then, with ``masked``, the
    mask_input arm: one batch of ``batch`` train links masked out of the
    propagation weights (mask_edge_weights), renormalised on the card
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
    with torch.no_grad():
        _, sweeps, gathers = _counting_tier_sweeps(
            lambda: spmm.spmm_bbell(g.bbell, x, diag=g.w_diag))
    log(f"BlockedBELL layer: {sweeps} tier sweeps, {gathers} slot-chunk "
        f"gathers (kb {g.bbell.kb}, {len(g.bbell.tiles)} tiles)")

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
    if not masked:
        del bell, blk, x
        torch.cuda.empty_cache()
        return

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


def _mixed_sums_check(t, a, label):
    """Row 2's per-class weight-grad sums (dw1cat, dg, db, dcb) on the
    backward inputs ``a`` against the same sums of the plain version's
    per-slot terms in f64 (measure.mixed_bwd_f64), over the sums of their
    magnitudes, held as SUM_TOL's comment says; the plain version's own
    distance to them logged beside."""
    got = t["bwd"](**a)
    want = in_link_chunks(t["bwd_plain"], a, 2)
    wit = measure.mixed_bwd_f64(**a)
    ok_, text = True, []
    for n, i, ex, mag in zip(("dw1cat", "dg", "db", "dcb"), (2, 3, 4, 6),
                             wit[:4], wit[4:]):
        err = (got[i].double() - ex).abs()
        perr = (want[i].double() - ex).abs()
        worst = float((err / mag.clamp_min(1e-300)).max())
        mean = float(err.mean() / mag.mean().clamp_min(1e-300))
        ok_ &= bool((err <= SUM_TOL * mag).all()) and mean <= SUM_TOL_MEAN
        pworst = float((perr / mag.clamp_min(1e-300)).max())
        pmean = float(perr.mean() / mag.mean().clamp_min(1e-300))
        text.append(f"{n} {worst:.2e}/{mean:.2e} (plain {pworst:.2e}/"
                    f"{pmean:.2e})")
    log(f"kernel bwd combined {label}: per-class weight grads against their "
        f"f64 sums, over the sums of their terms' magnitudes (max/mean; tol "
        f"{SUM_TOL}/{SUM_TOL_MEAN}): " + ", ".join(text))
    if not ok_:
        raise AssertionError(f"combined backward kernel at {label}: weight "
                             f"grads off their f64 sums")


def phase_ppa_kernels(dev, card, ds, tabs, cfg, batch):
    """Phase 16 (c): rows 1-3 on the inputs the ppa-like preset's own
    training batch gives them (B = batch, C = the combined budget, O = dh
    = dim, bf16; dropout off, the held steps' batch and negatives):
    one step's loss and backward through the kernels, recording each
    call's inputs (measure.recording_kernel_inputs), then each recorded
    call of rows 1 and 2 (the positive and the negative half) against its
    plain version (TOL, BWD_TOL), row 2's per-class weight grads also
    against their f64 sums (SUM_TOL), and each of row 3 against its plain
    version beside index_add_ (profile_kernels.scatter_report)."""
    from lpformer_tpu_torch.ops import masking, scatter
    from lpformer_tpu_torch.profile_kernels import scatter_report
    from lpformer_tpu_torch.train import step as step_mod

    t = tabs["combined"]
    c = _nodrop(cfg)
    params = _fresh_params(dev, c, int(ds.graph.x.shape[1]))
    pos, neg, w = _step_inputs(ds, batch, dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)
    with measure.recording_kernel_inputs() as rec:
        step_mod.loss_fn(params, c, ds.graph, pos[:, 0], pos[:, 1], neg[0],
                         neg[1], w, mr, None).backward()
    del params
    halves = ("positives", "negatives")
    if len(rec["fwd"]) != 2 or len(rec["bwd"]) != 2:
        raise AssertionError(f"recorded {len(rec['fwd'])} forward and "
                             f"{len(rec['bwd'])} backward calls, not 2")
    for half, a in zip(halves, rec["fwd"]):
        n = a["valid"].sum(1)
        log(f"valid slots per link (ppa-like train batch, {half}): mean "
            f"{n.float().mean():.2f}, quantiles 0-100% by 5: "
            f"{_count_quantiles(n)} of {a['valid'].shape[1]}")
        _fwd_check("combined", t, a, torch.bfloat16,
                   f"ppa-like step's {half}",
                   (5, 5) if half == "positives" else (3, 2))
    for a in rec["bwd"]:
        half = next(h for h, f in zip(halves, rec["fwd"])
                    if f["valid"].data_ptr() == a["valid"].data_ptr())
        _bwd_check_timed("combined", t, a, torch.bfloat16,
                         f"ppa-like step's {half}",
                         (5, 5) if half == "positives" else (3, 2))
        _mixed_sums_check(t, a, f"ppa-like step's {half}")
    for i, (ids, ct, n, live) in enumerate(rec["scatter"]):
        scatter_report(card, f"ppa-like step's call {i + 1}", ids, ct, n,
                       live, log=log)
        plain_ms = time_ms(
            lambda: scatter.scatter_rows_add_plain(ids, ct, n, live), 3, 1)
        log(f"scatter ppa-like call {i + 1} plain version {plain_ms:.4f} ms")
    if len(rec["scatter"]) != 2:
        raise AssertionError(f"{len(rec['scatter'])} scatter calls, not 2")
    del rec
    torch.cuda.empty_cache()


def phase_ppa_train(dev, card, ds, tabs, cfg, batch, steps=8):
    """Phase 16 (d): the ppa-like step with the residual GCN, one step
    through the kernels against the plain versions in bf16 (STEP_*) and in
    f32 (STEP_F32_*), dropout off and fixed negatives; then ``steps``
    steps with the default dropouts: every loss finite, rows 1-3 launched
    once per call, every other kernel never; stage times and peak
    memory."""
    t = tabs["combined"]
    label = "combined (ppa-like, residual)"
    _step_pair(dev, ds, label, tabs, cfg, batch)
    torch.cuda.empty_cache()
    _step_pair(dev, ds, label, tabs,
               dataclasses.replace(cfg, matmul_dtype="float32"), batch)
    torch.cuda.empty_cache()
    counters = _zeroed(tabs)
    losses, _ = _timed_steps(dev, card, ds, label, cfg, batch, steps)
    want = dict.fromkeys(counters, 0)
    for name in (t["fwd_entry"][0], t["bwd_entry"][0], "scatter_rows_add"):
        want[name] = 2 * steps * cfg.trans_layers
    lv = torch.stack(losses).cpu()
    log("ppa-like steps: losses " + ", ".join(f"{x:.4f}" for x in lv.tolist()))
    _check_launches(f"ppa-like {steps} steps", counters, want, card)
    if not bool(torch.isfinite(lv).all()):
        raise AssertionError("a ppa-like training loss is not finite")


def phase_ppa_classic(dev, card, ds, tabs, batch):
    """Phase 16 (e): the ppa-like classic table (64 | 128 | 128, C = 320),
    where the auto rule turns the pairwise block's remat on: one bf16 step
    through the kernels against the plain versions (STEP_*), rows 4, 5
    and 3 launched as the kernel step's calls say (row 4 once more a
    forward under remat), every other kernel never; its peak memory."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.models import link_transformer as lt

    cfg = presets.PPA_LIKE_CLASSIC_CONFIG
    c = sum(cfg.context.class_budgets)
    if not lt.remat_pairwise_on(cfg, batch, c):
        raise AssertionError("the auto rule must turn remat on here")
    t = tabs["classic"]
    counters = _zeroed(tabs)
    torch.cuda.reset_peak_memory_stats()
    _step_pair(dev, ds, "classic (ppa-like, residual, remat)", tabs, cfg,
               batch)
    log(f"ppa-like classic step pair (C {c}): peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    want = dict.fromkeys(counters, 0)
    want[t["fwd_entry"][0]] = 4 * cfg.trans_layers
    want[t["bwd_entry"][0]] = 2 * cfg.trans_layers
    want["scatter_rows_add"] = 2 * cfg.trans_layers
    _check_launches("ppa-like classic step (remat)", counters, want, card)
    torch.cuda.empty_cache()


def phase_ppa_eval(dev, card, ds, tabs, cfg, batch):
    """Phase 16 (f): run_eval -> test_standard at test batch ``batch``
    over every split (the 1,000,000 negative pairs of each of valid and
    test among them): every score finite, Hits@20/50/100 in [0, 1] (the
    dataset's metric, Hits@100: no MRR), row 1 launched once per score
    batch and no other kernel, one batch of negatives through the kernel
    within SCORE_TOL of the plain path; propagate ms and links/s."""
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops.context import extract_context
    from lpformer_tpu_torch.train import trainer

    t = tabs["combined"]
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    sizes = [len(x) for x in (ds.train_pos_val, ds.valid_pos, ds.test_pos,
                              ds.valid_neg, ds.test_neg)]
    n_batches = sum(-(-m // batch) for m in sizes)
    with _recording(harness, "score_edges", []) as scored:
        counters = _zeroed(tabs)
        t0 = time.perf_counter()
        res = trainer.run_eval(params, cfg, ds,
                               trainer.TrainArgs(test_batch_size=batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    links = sum(len(x) for x in scored)
    with torch.no_grad():
        prop_ms = time_ms(lambda: lt.propagate(params, cfg, ds.graph), 2, 1)
    log(f"run_eval -> test_standard (ppa-like, batch {batch}): "
        f"{wall * 1e3:.1f} ms wall, {links} links in {n_batches} batches; "
        + ", ".join(f"{k} " + "/".join(f"{x:.4f}" for x in v)
                    for k, v in res.items()) + " (train/valid/test); "
        f"propagate {prop_ms:.1f} ms; {links / wall:.0f} links/s over the "
        f"sweep  [{card}]")
    want = dict.fromkeys(counters, 0)
    want[t["fwd_entry"][0]] = n_batches * cfg.trans_layers
    _check_launches("ppa-like sweep", counters, want, card)
    if [len(x) for x in scored] != sizes or not all(
            np.isfinite(x).all() for x in scored):
        raise AssertionError("ppa-like scores not finite or of the wrong "
                             "shape")
    if sorted(res) != ["Hits@100", "Hits@20", "Hits@50"] or not all(
            0.0 <= x <= 1.0 for v in res.values() for x in v):
        raise AssertionError(f"ppa-like metrics out of range: {res}")

    # the first batch of the valid negatives: kernel vs plain, and its
    # valid slots per link
    with torch.no_grad():
        X = lt.propagate(params, cfg, ds.graph)
        src, tgt = _scores_vs_plain(dev, ds.graph, t, harness.make_score_fn(
            cfg), params, X, ds.valid_neg[:batch], "ppa-like")
        n = extract_context(ds.graph.adj_rows, ds.graph.ppr_rows, src, tgt,
                            cfg.context).valid.sum(1)
    log(f"valid slots per link (ppa-like eval sweep's negatives): mean "
        f"{n.float().mean():.2f}, quantiles 0-100% by 5: "
        f"{_count_quantiles(n)} of {cfg.budget_combined}")


def phase_ppa(dev, card, tabs, stamp):
    """Phase 16, the ppa-like preset (presets.py: 576,000 nodes, 15,000,000
    train edges, dim 64, batch 32768, the combined table of 96, residual
    GCN; measure.ppa_like_dataset): (a) the cold host build, a
    BlockedBELL of kb 5 and no ELL; (b) one GCN layer's SpMM against a
    single BucketedELL and a static BlockedCOO; (c) rows 1-3 on the
    preset's own extracted tables; (d) the residual step pair in bf16 and
    f32, then 8 timed steps; (e) the classic table's step pair under
    remat; (f) the Hits@100 sweep."""
    from lpformer_tpu_torch import presets

    cfg, batch = presets.PPA_LIKE_CONFIG, presets.PPA_LIKE_BATCH
    ds = _big_build("ppa-like", lambda: measure.ppa_like_dataset(dev), 5)
    stamp("ppa-like build (phase 16 a)")
    phase_big_spmm(dev, card, ds, cfg.dim, batch, masked=False)
    phase_ppa_kernels(dev, card, ds, tabs, cfg, batch)
    stamp("ppa-like SpMM and kernel checks (phase 16 b, c)")
    phase_ppa_train(dev, card, ds, tabs, cfg, batch)
    phase_ppa_classic(dev, card, ds, tabs, batch)
    stamp("ppa-like training (phase 16 d, e)")
    phase_ppa_eval(dev, card, ds, tabs, cfg, batch)
    stamp("ppa-like sweep (phase 16 f)")
    del ds
    torch.cuda.empty_cache()


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

def _pe_rows_quiet(label, counters, tabs, want_scatter, card):
    """The launch counts of a dense-route run: rows 1, 2, 4 and 5 (the
    PE+attention pairs), and every other kernel but the scatter, at 0;
    the scatter at ``want_scatter``."""
    want = dict.fromkeys(counters, 0)
    want["scatter_rows_add"] = want_scatter
    _check_launches(label, counters, want, card)


def _dense_scores_vs_kernel(dev, ds, cfg, kernel_cfg, links, label, card):
    """One batch of eval links scored in f32 through the dense route and
    through the kernel route, on the same parameters: max and mean |diff|
    within TOL[f32]."""
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt

    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    tl = torch.as_tensor(links, dtype=torch.int64, device=dev)
    src, tgt = tl[:, 0], tl[:, 1]
    with torch.no_grad():
        X = lt.propagate(params, cfg, ds.graph)
        dense, kern = (harness.make_score_fn(c)(params, ds.graph, X, src,
                                                tgt)
                       for c in (cfg, kernel_cfg))
    err = (dense - kern).abs()
    tol, tol_mean = TOL[torch.float32]
    log(f"scores {label} f32 dense vs kernel route ({len(links)} links): "
        f"max abs err {float(err.max()):.3e}, mean {float(err.mean()):.3e} "
        f"(tol {tol}/{tol_mean})  [{card}]")
    if (not bool(torch.isfinite(dense).all()) or float(err.max()) > tol
            or float(err.mean()) > tol_mean):
        raise AssertionError(f"{label}: the dense route's scores disagree "
                             f"with the kernel route's")


def _to_f64(obj):
    """A copy of a tensor, or of a (nested) dataclass, list, tuple or dict
    of them, with every float32 tensor in float64."""
    if torch.is_tensor(obj):
        return obj.double() if obj.dtype == torch.float32 else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_f64(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_f64(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_f64(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _route_pair_f32(dev, ds, tabs, layout, kernel, batch):
    """One f32 training step (dropout off, fixed negatives) through the
    dense route against the kernel route on the same parameters: the loss
    within STEP_F32_LOSS_TOL, every leaf within STEP_F32_ROUTE_GRAD_TOL;
    and, logged only, each route against an f64 run of the dense route
    (its gathers' backward sums in f32, as everywhere)."""
    from lpformer_tpu_torch.ops import gather, masking
    from lpformer_tpu_torch.train import optim, step as step_mod

    kernel = dataclasses.replace(kernel, matmul_dtype="float32", dropout=0.0,
                                 gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
                                 pred_drop=0.0)
    dense = dataclasses.replace(kernel, use_pallas_attention=False)
    params = _fresh_params(dev, kernel, int(ds.graph.x.shape[1]))
    paths = optim.tree_leaves_with_path(params)
    pos = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    neg = torch.randint(0, ds.num_nodes, (2, batch),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    w = torch.ones(batch, device=dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)

    def step(cfg, graph, p, weight):
        leaves = optim.tree_leaves(p)
        loss = step_mod.loss_fn(p, cfg, graph, pos[:, 0], pos[:, 1], neg[0],
                                neg[1], weight, mr, None)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    got = {"kernel": step(kernel, ds.graph, params, w),
           "dense": step(dense, ds.graph, params, w)}
    label = f"train step {layout} (dim {kernel.dim}, batch {batch}, float32)"
    _compare_steps(f"{label} dense vs kernel route", got["dense"],
                   got["kernel"], paths, STEP_F32_LOSS_TOL,
                   STEP_F32_ROUTE_GRAD_TOL)
    restore = _plain_training_path(tabs)
    saved = gather._SCATTER_MIN_ROWS
    gather._SCATTER_MIN_ROWS = 1 << 62      # index_add_ takes float64 ct
    try:
        p64 = optim.tree_map(
            lambda t: t.detach().double().requires_grad_(True), params)
        wit = step(dense, _to_f64(ds.graph), p64, w.double())
    finally:
        gather._SCATTER_MIN_ROWS = saved
        restore()
    for route in ("dense", "kernel"):
        _compare_steps(f"{label} {route} route vs an f64 dense run",
                       (got[route][0].double(),
                        [g.double() for g in got[route][1]]),
                       wit, paths, hold=False)
    del got, wit, p64


def phase_dense(dev, card, ds, tabs, batch, steps=5):
    """Phase 14, the dense attention route (use_pallas_attention=False, or
    num_heads > 1) on the collab-like dataset at its full widths:
      (a) for each table layout, the dense route against the kernel route
          in f32 (one step's loss and gradients, STEP_F32_ROUTE_GRAD_TOL;
          one eval batch's scores, TOL[f32]),
          against itself with row 3 swapped for its plain version in bf16,
          and its bf16 gap to the kernel route (logged, not held); one
          eval batch and ``steps`` timed steps of each route, the dense
          runs launching row 3 twice a step and rows 1, 2, 4 and 5 never;
      (b) num_heads=2 on the combined table (H*O = 256, pairwise width
          260): a step against plain row 3, ``steps`` timed steps and the
          eval sweep over the preset's eval links with the trained
          parameters (losses finite, metrics in [0, 1], launches as (a));
      (c) test_by_cn_bins over the test split with (b)'s parameters: the
          bins' counts add up to the test positives whose CN count lies
          in the bins.
    Returns {route: step stats} for the summary line."""
    from lpformer_tpu_torch.evalx import analysis, harness

    summary = {}
    links = _eval_links(ds, batch)
    f32 = dict(matmul_dtype="float32")
    for layout, t in tabs.items():
        kernel = t["cfg"]
        dense = dataclasses.replace(kernel, use_pallas_attention=False)
        _route_pair_f32(dev, ds, tabs, layout, kernel, batch)
        _dense_scores_vs_kernel(dev, ds, dataclasses.replace(dense, **f32),
                                dataclasses.replace(kernel, **f32), links,
                                layout, card)
        torch.cuda.empty_cache()
        _step_pair(dev, ds, f"{layout}, dense route", tabs, dense, batch)
        _, dl, gap = _step_pair(dev, ds, f"{layout}, dense route (bf16 gap)",
                                tabs, dense, batch, against=kernel,
                                hold=False)
        torch.cuda.empty_cache()
        counters = _zeroed(tabs)
        ms = {"dense": _eval_batch_ms(
            dev, ds, dense, links, lambda: _pe_rows_quiet(
                f"phase 14 {layout} dense eval batch", counters, tabs, 0,
                card)),
              "kernel": _eval_batch_ms(dev, ds, kernel, links)}
        for route, cfg in (("dense", dense), ("kernel", kernel)):
            st = {}
            counters = _zeroed(tabs)
            _timed_steps(dev, card, ds, f"{layout}, {route} route", cfg,
                         batch, steps + 2, stats=st)
            if route == "dense":
                _pe_rows_quiet(f"phase 14 {layout} dense steps", counters,
                               tabs, 2 * (steps + 2) * cfg.trans_layers,
                               card)
            st.pop("params")
            summary[f"{layout} {route}"] = dict(st, eval_ms=ms[route])
            torch.cuda.empty_cache()
        summary[f"{layout} dense"].update(bf16_loss_gap=dl,
                                          bf16_grad_gap=gap)

    # (b) two heads on the combined table
    cfg2 = dataclasses.replace(tabs["combined"]["cfg"], num_heads=2)
    _step_pair(dev, ds, "combined, 2 heads (dense route)", tabs, cfg2, batch)
    st = {}
    counters = _zeroed(tabs)
    losses, _ = _timed_steps(dev, card, ds, "combined, 2 heads", cfg2, batch,
                             steps + 2, stats=st)
    _pe_rows_quiet("phase 14 two-head steps", counters, tabs,
                   2 * (steps + 2) * cfg2.trans_layers, card)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError("a two-head training loss is not finite")
    params = st.pop("params")
    counters = _zeroed(tabs)
    t0 = time.perf_counter()
    res = harness.test_standard(params, cfg2, ds, batch_size=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"test_standard combined, 2 heads: {wall * 1e3:.1f} ms wall; "
        + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}"
                    for k, v in res.items()) + f"  [{card}]")
    _pe_rows_quiet("phase 14 two-head eval sweep", counters, tabs, 0, card)
    for k, v in res.items():
        if not all(0.0 <= x <= 1.0 for x in v):
            raise AssertionError(f"{k} out of range: {v}")
    summary["combined 2 heads"] = dict(st, eval_ms=wall * 1e3)

    # (c) Hits@100 by CN bin on the test split, (b)'s parameters
    t0 = time.perf_counter()
    bins = analysis.test_by_cn_bins(params, cfg2, ds, batch_size=batch)
    wall = time.perf_counter() - t0
    cn = analysis.compute_edge_cn(ds, np.asarray(ds.test_pos))
    lo, hi = 0, float("inf")     # test_by_cn_bins' default outer edges
    want_n = int(((cn >= lo) & (cn < hi)).sum())
    log(f"test_by_cn_bins (collab-like test split, 2 heads): {bins}; "
        f"{want_n} positives in the bins, {wall:.1f} s  [{card}]")
    if (sum(v["n"] for v in bins.values()) != want_n
            or not all(0.0 <= v["Hits@100"] <= 1.0 for v in bins.values())):
        raise AssertionError(f"test_by_cn_bins: {bins}")
    del params
    torch.cuda.empty_cache()
    return summary


def _eval_batch_ms(dev, ds, cfg, links, check=None):
    """One eval batch scored through ``cfg`` (finite scores of the right
    shape), then its CUDA-event ms; ``check()`` runs between the two."""
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt

    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=int(ds.graph.x.shape[1]), device=dev)
    tl = torch.as_tensor(links, dtype=torch.int64, device=dev)
    src, tgt = tl[:, 0], tl[:, 1]
    with torch.no_grad():
        X = lt.propagate(params, cfg, ds.graph)
        fn = harness.make_score_fn(cfg)
        scores = fn(params, ds.graph, X, src, tgt)
        torch.cuda.synchronize()
        if (scores.shape != (len(links),)
                or not bool(torch.isfinite(scores).all())):
            raise AssertionError("eval scores not finite")
        if check is not None:
            check()
        return time_ms(lambda: fn(params, ds.graph, X, src, tgt), 5)


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
    if torch.cuda.is_available():
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


def _check_npz(npz, edges, c, card):
    """attention_weights.npz as --dump-att writes it: keys edges, ids,
    valid, alpha; edges the dumped links, the rest [len(edges), c]; alpha
    exactly 0 on invalid slots and summing to 1 within 1e-5 over each
    link's valid ones."""
    shapes = {k: v.shape for k, v in npz.items()}
    log(f"attention_weights.npz: {shapes}  [{card}]")
    if (sorted(npz) != ["alpha", "edges", "ids", "valid"]
            or not np.array_equal(npz["edges"], edges)
            or not shapes["ids"] == shapes["valid"] == shapes["alpha"]
            == (len(edges), c)):
        raise AssertionError("attention_weights.npz: wrong keys or shapes")
    valid, alpha = npz["valid"], npz["alpha"]
    has = valid.any(1)
    err = float(np.abs(alpha[has].sum(1) - 1.0).max())
    off = float(np.abs(alpha[~valid]).max(initial=0.0))
    log(f"attention_weights.npz: {int(has.sum())} of {len(edges)} links "
        f"with a valid slot, {int(valid.sum())} valid slots; max |sum alpha "
        f"- 1| {err:.2e} (tol 1e-5), max |alpha| on invalid slots {off}")
    if not has.any() or not err <= 1e-5 or off != 0.0:
        raise AssertionError("attention_weights.npz: alpha malformed")


def phase_cli_cora_heart(dev, card, tabs):
    """Phase 13: ``--config cora-heart`` through the CLI for one run of one
    epoch with one eval (--eval_steps 1; the config's 5 would leave one
    epoch unevaluated) on a Cora-sized Planetoid + HeaRT fixture
    (_write_cora_like): dim 256, 1 GCN layer without LayerNorm and ReLU,
    eps 1e-7, rows 3-5 at dh = 256 in f32, with --save-as and --dump-att;
    the HeaRT MRR in [0, 1] and the launches as predicted; the dump (one
    dense-route call on the best checkpoint, which launches none of rows
    1-5) writes attention_weights.npz: the first test_batch_size test
    positives, alpha [B, C] 0 on invalid slots and summing to 1 on each
    link's valid ones; then rows 4-5 and one training step against their
    plain versions at the path's shapes, as phase 12."""
    from lpformer_tpu_torch.cli import run

    t = tabs["classic"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        sizes = _write_cora_like(data)
        argv = ["--config", "cora-heart", "--data-dir", data, "--runs", "1",
                "--epochs", "1", "--eval_steps", "1", "--save-as", "smoke",
                "--dump-att", "--checkpoint-dir",
                os.path.join(tmp, "checkpoints")]
        args = run.apply_config(run.build_parser(), argv)
        os.chdir(tmp)
        dump = []
        real_dump = run._dump_attention

        def counted_dump(*a, **kw):
            torch.cuda.synchronize()
            before = {n: f.launches for n, f in counters.items()}
            real_dump(*a, **kw)
            torch.cuda.synchronize()
            dump.append({n: f.launches - before[n]
                         for n, f in counters.items()})

        run._dump_attention = counted_dump
        try:
            counters = _zeroed(tabs)
            torch.cuda.reset_peak_memory_stats()
            with _recording(run, "load_dataset", []) as kept:
                _, out, wall = _cli(argv)
            with np.load(os.path.join(tmp, "attention_weights.npz")) as z:
                npz = {k: z[k] for k in z.files}
        finally:
            run._dump_attention = real_dump
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
    log(f"phase 13 --dump-att call(s): launches {dump} (predicted one call, "
        f"every count 0)  [{card}]")
    if dump != [dict.fromkeys(counters, 0)]:
        raise AssertionError(f"phase 13 --dump-att launches {dump}")
    _check_npz(npz, ds.test_pos[:args.test_batch_size],
               cfg.context.total_budget, card)
    _hold_path_kernels(dev, tabs, "cora-heart CLI", cfg, args)
    _step_pair(dev, ds, "classic (cora-heart CLI)", tabs, cfg,
               args.batch_size)
    del ds
    torch.cuda.empty_cache()


# Phase 15's mesh: 4 ranks as a 2 x 2 mesh, every rank on the one card,
# exchanging through gloo (NCCL puts one rank on a card)
MESH_SHAPE = (2, 2)
MESH_STEPS = 8
# phase 15 (b)'s CLI runs: the collab-like preset's widths (dim 128, 3 GCN
# layers, bf16, the combined table of 128, batch 4096) on a synthetic graph
# of 5,000 nodes, one epoch of 10 steps
MESH_CLI = ["--data_name", "synthetic", "--syn-nodes", "5000",
            "--syn-edges", "40000", "--syn-feat", "128", "--eps", "5e-4",
            "--dim", "128", "--gnn-layers", "3", "--matmul-dtype",
            "bfloat16", "--budget-combined", "128", "--budget-cn", "64",
            "--budget-onehop", "128", "--budget-non1hop", "128",
            "--batch-size", "4096", "--test-batch-size", "4096",
            "--epochs", "1", "--eval_steps", "1", "--runs", "1"]
DRYRUN_RANKS = 8


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counts(counters):
    return {n: f.launches for n, f in counters.items()}


def _mesh_variants():
    """(name, config, make_sharded_loss keywords, held tolerances) of
    phase 15's steps: the collab-like combined table plain,
    context-parallel (C 128 over g = 2) and mask_input, and the classic
    table plain, each in bf16 (the preset's dtype) and in f32.

    The f32 steps hold the loss and every gradient leaf
    (STEP_F32_LOSS_TOL, STEP_F32_ACCUM_GRAD_TOL: the split batch's f32
    sums in another order, as grad_accum's). The bf16 steps hold the loss
    (STEP_LOSS_TOL) and the gradients as MESH_BF16_* says (None here)."""
    from lpformer_tpu_torch import presets

    out = []
    for dtype in ("bfloat16", "float32"):
        def cfg_of(c):
            return dataclasses.replace(c, matmul_dtype=dtype)

        tols = ((STEP_LOSS_TOL, None) if dtype == "bfloat16" else
                (STEP_F32_LOSS_TOL, STEP_F32_ACCUM_GRAD_TOL))
        sfx = "" if dtype == "bfloat16" else " f32"
        cfg = cfg_of(presets.COLLAB_LIKE_CONFIG)
        out += [("plain" + sfx, cfg, {}, tols),
                ("context_parallel" + sfx, cfg, {"context_parallel": True},
                 tols),
                ("mask_input" + sfx, cfg, {"mask_input": True}, tols),
                ("classic" + sfx, cfg_of(presets.COLLAB_LIKE_CLASSIC_CONFIG),
                 {}, tols)]
    return out


def _single_step(dev, ds, cfg, batch, mask_input, counters, micro=1):
    """The single-device step of ``_step_inputs``' batch, dropout off,
    split into ``micro`` micro-batches as grad_accum splits it (the
    full batch's mask and denominators, the gradients summed): (loss,
    grads, leaves with paths, the launches of the forwards and the
    backwards)."""
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.train import optim, step as step_mod

    params = _fresh_params(dev, _nodrop(cfg), int(ds.graph.x.shape[1]))
    leaves = optim.tree_leaves(params)
    pos, neg, w = _step_inputs(ds, batch, dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)
    prop_w = (masking.mask_edge_weights(mr, ds.graph.edge_rank,
                                        (ds.graph.edge_w > 0).float())
              if mask_input else None)
    for f in counters.values():
        f.launches = 0
    mb = batch // micro
    loss, grads = 0.0, None
    for i in range(micro):
        sl = slice(i * mb, (i + 1) * mb)
        part = step_mod.loss_fn(
            params, _nodrop(cfg), ds.graph, pos[sl, 0], pos[sl, 1],
            neg[0, sl], neg[1, sl], w[sl], mr, None, prop_w, mask_input,
            pos_denom=w.sum(), neg_denom=w.sum())
        g = torch.autograd.grad(part, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss = loss + part.detach()
    _sync(dev)
    return (loss, grads, optim.tree_leaves_with_path(params),
            _launch_counts(counters))


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _mesh_rank(rank, spec):
    """One rank of phase 15: the collab-like dataset on the host (the PPR
    from the parent's cache), this rank's shards on its device; each
    variant's sharded loss and global gradient, dropout off, with the
    launch counts of its forward and backward; then, when ``spec``
    asks, MESH_STEPS training steps (ms, peak memory, the parameters'
    digest) and the eval sweep through ShardedEvalContext."""
    import torch.distributed as dist

    from lpformer_tpu_torch.data.synthetic import synthetic_dataset
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_loss, make_sharded_train_step,
        partition_graph, place_sharded_graph,
    )
    from lpformer_tpu_torch.parallel.eval import ShardedEvalContext
    from lpformer_tpu_torch.parallel.sharded_step import value_and_grad
    from lpformer_tpu_torch.train import optim
    from lpformer_tpu_torch.train.step import TrainState

    dev = distributed.rank_device()
    t0 = time.perf_counter()
    ds = synthetic_dataset(**spec["data"], ppr_cache_dir=spec["ppr_cache"],
                           device="cpu")
    d, g = spec["mesh"]
    mesh = make_mesh(d, g)
    sg = place_sharded_graph(
        partition_graph(ds.graph, g=g, d=d, mask_input=True), mesh)
    out = dict(build_s=time.perf_counter() - t0,
               backend=dist.get_backend(), device=str(dev),
               ctx_rows=int(sg.adj_nbrs.shape[0]), variants={})
    counters = _counters(tables())
    in_dim = int(ds.graph.x.shape[1])
    mult = ds.mask_mult_device.to(dev)
    pos, neg, w = _step_inputs(ds, spec["batch"], dev)
    for name, cfg, kw, _ in spec["variants"]:
        params = _fresh_params(dev, _nodrop(cfg), in_dim)
        loss_fn = make_sharded_loss(_nodrop(cfg), mesh, ds.num_nodes,
                                    sg.rows_per_shard, sg.ctx_rows_per_shard,
                                    **kw)
        for f in counters.values():
            f.launches = 0
        loss, grads = value_and_grad(loss_fn, mesh, params, sg, mult,
                                     pos[:, 0], pos[:, 1], w, neg[0], neg[1],
                                     w)
        _sync(dev)
        out["variants"][name] = dict(
            loss=float(loss), launches=_launch_counts(counters),
            grads=([x.cpu().numpy() for x in optim.tree_leaves(grads)]
                   if rank == 0 else None))
    if spec.get("nccl_check"):
        # every collective the mesh path calls, on the card's tensors
        x = torch.arange(8, dtype=torch.float32, device=dev)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        a2a = torch.empty_like(x)
        dist.all_to_all_single(a2a, x, [8], [8])
        red = x.clone()
        dist.all_reduce(red)
        if not all(torch.equal(t, x) for t in (parts[0], a2a, red)):
            raise AssertionError("NCCL collectives returned wrong values")
    if spec.get("cli"):
        out["cli"] = _mesh_cli(spec["cli"], ["--mesh", "1,1"])
    if not spec.get("steps"):
        return out

    cfg, batch = spec["train_cfg"], spec["batch"]
    params = _fresh_params(dev, cfg, in_dim)
    opt = optim.make_optimizer(1e-3, steps_per_epoch=spec["steps"])
    step = make_sharded_train_step(cfg, opt, mesh, ds.num_nodes,
                                   sg.rows_per_shard, sg.ctx_rows_per_shard)
    state = TrainState(params, opt.init(params), 0)
    for f in counters.values():
        f.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for _ in range(spec["steps"]):
        _sync(dev)
        t = time.perf_counter()
        state, loss = step(state, sg, mult, pos[:, 0], pos[:, 1], w, 0)
        _sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    out.update(
        losses=losses, step_ms=times, train_launches=_launch_counts(counters),
        params_digest=_digest(optim.tree_leaves(state.params)),
        peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                  if dev.type == "cuda" else None))

    # the eval sweep over the mesh, fresh parameters of the same seed
    params = _fresh_params(dev, cfg, in_dim)
    ctx = ShardedEvalContext(cfg, mesh, ds, sg_train=sg)
    with torch.no_grad():
        X = ctx.prop(params, ctx.sg)
        links = np.concatenate([ds.train_pos_val, ds.valid_pos, ds.test_pos,
                                ds.valid_neg, ds.test_neg])
        scores = harness.score_edges(ctx.score, params, ctx.sg, X, links,
                                     batch)
    for f in counters.values():
        f.launches = 0
    _sync(dev)
    t = time.perf_counter()
    metrics = harness.test_standard(params, cfg, ds, batch_size=batch,
                                    sharded=ctx)
    _sync(dev)
    out.update(scores=scores if rank == 0 else None, metrics=metrics,
               eval_ms=(time.perf_counter() - t) * 1e3,
               eval_launches=_launch_counts(counters))
    return out


def _cli_counted(argv):
    """One CLI run: its result, printed metrics, launches, wall seconds
    and eval scores (one array per score_edges call)."""
    from lpformer_tpu_torch.evalx import harness

    counters = _zeroed(tables())
    with _recording(harness, "score_edges", []) as sink:
        result, text, wall = _cli(argv)
    return dict(result=result, metrics=_printed_metrics(text),
                launches=_launch_counts(counters), wall_s=wall, scores=sink)


def _mesh_cli(cli, extra):
    """The CLI (``cli``: its argv and checkpoint directory) for one epoch
    with --save-as, then the checkpoint's eval, each with ``extra``
    appended (``--mesh 1,1`` on a rank)."""
    argv = cli["argv"] + ["--checkpoint-dir", cli["ckpt"]] + extra
    return dict(train=_cli_counted(argv + ["--save-as", "mesh"]),
                eval=_cli_counted(argv + ["--checkpoint", "mesh"]))


def _hold_scores(label, got, want, suffix=""):
    """Two runs' eval scores (lists of arrays, pairwise of one shape)
    within TOL[bf16], max and mean abs error, every score finite."""
    tol = TOL[torch.bfloat16]
    same = len(got) == len(want) and all(
        a.shape == b.shape for a, b in zip(got, want))
    g = np.concatenate([a.ravel() for a in got]) if got else np.zeros(0)
    err = (np.abs(g.astype(np.float64) - np.concatenate(
        [b.ravel() for b in want])) if same and g.size else np.full(1, np.inf))
    log(f"{label}: {g.size} scores, max abs err {err.max():.3e}, mean "
        f"{err.mean():.3e} (tol {tol}){suffix}")
    if (not same or not np.isfinite(g).all() or err.max() > tol[0]
            or err.mean() > tol[1]):
        raise AssertionError(f"{label}: the scores disagree")


def _hold_mesh_cli(mesh, single, backend, dev, card):
    """Phase 15 (b)'s CLI runs: the mesh's launches equal the single
    device's, training and eval; the mesh checkpoint's eval over the mesh
    against the single-device CLI's eval of it."""
    def test(metrics):
        return {k: v[2] for k, v in metrics.items()}

    m, s_ = mesh["train"], single["train"]
    log(f"phase 15 (b) CLI --mesh 1,1 over {backend}, one epoch: "
        f"{m['wall_s']:.1f} s, best valid "
        f"{m['result']}, test {test(m['metrics'])}; the single-device CLI "
        f"{s_['wall_s']:.1f} s, best valid {s_['result']}, test "
        f"{test(s_['metrics'])} (dropout draws differ)  [{card}]")
    if not m["metrics"] or not all(
            0.0 <= x <= 1.0 for v in m["metrics"].values() for x in v):
        raise AssertionError("CLI --mesh 1,1: no metrics in [0, 1]")
    _hold_rank_launches("CLI --mesh 1,1 training, eval included",
                        [m["launches"]], s_["launches"], dev)
    m, s_ = mesh["eval"], single["eval"]
    _hold_rank_launches("CLI --checkpoint --mesh 1,1", [m["launches"]],
                        s_["launches"], dev)
    gap = max(abs(m["metrics"][k][i] - v[i])
              for k, v in s_["metrics"].items() for i in range(3))
    _hold_scores("phase 15 (b) CLI --checkpoint --mesh 1,1 vs the "
                 "single-device CLI's eval of the same checkpoint",
                 m["scores"], s_["scores"],
                 f"; metrics {test(m['metrics'])} vs {test(s_['metrics'])},"
                 f" max |diff| {gap:.2e}; {m['wall_s']:.1f} s vs "
                 f"{s_['wall_s']:.1f} s  [{card}]")


def _hold_mesh_bf16(label, got_grads, ref, dev):
    """A bf16 mesh step's gradient leaves against ``ref``'s as
    MESH_BF16_* says: the median leaf, every leaf and the GCN's leaves."""
    paths = ["/".join(map(str, p)) for p, _ in ref[2]]
    rel = [float((torch.as_tensor(g, device=dev) - y).norm()
                 / y.norm().clamp_min(1e-30)) for g, y in zip(got_grads,
                                                              ref[1])]
    gcn = [e for e, p in zip(rel, paths) if p.startswith(MESH_BF16_GCN)]
    med = statistics.median(rel)
    log(f"  bf16 gradients: median leaf {med:.2e} (tol "
        f"{MESH_BF16_MEDIAN_TOL}), max {max(rel):.2e} at "
        f"{paths[rel.index(max(rel))]} (tol {MESH_BF16_LEAF_TOL}), the "
        f"GCN's {len(gcn)} leaves max {max(gcn):.2e} (tol {STEP_GRAD_TOL})")
    if (med > MESH_BF16_MEDIAN_TOL or max(rel) > MESH_BF16_LEAF_TOL
            or max(gcn) > STEP_GRAD_TOL or not all(
                np.isfinite(g).all() for g in got_grads)):
        raise AssertionError(f"{label}: bf16 gradients disagree")


def _hold_rank_launches(label, per_rank, want, dev):
    """Every rank's launches equal the single-device path's (rows 6-8
    at 0 with them); on the card the path's rows were launched. Logs the
    non-zero counts."""
    shown = {n: v for n, v in want.items() if v}
    log(f"  {label}: launches per rank {shown or 'none'} = single device's "
        f"(the other rows 0) on all {len(per_rank)} ranks: "
        f"{all(r == want for r in per_rank)}")
    if any(r != want for r in per_rank):
        raise AssertionError(f"{label}: launches {per_rank} != {want}")
    if torch.device(dev).type == "cuda" and not shown:
        raise AssertionError(f"{label}: no kernel launched")


def phase_mesh(dev, card, ds, tabs, ppr_cache, batch):
    """Phase 15: the mesh path (parallel/).

    (a) 4 ranks as a 2 x 2 mesh, all on this card over gloo, at the
    collab-like preset's full width: the sharded loss and every gradient
    leaf, dropout off, held to the single-device step through the kernels
    over the same COO GCN (the mesh's), the batch split as the ranks
    split it, for the plain, context-parallel and mask_input variants of
    the combined table and the plain classic table, in f32
    (STEP_F32_LOSS_TOL, STEP_F32_ACCUM_GRAD_TOL) and in bf16
    (STEP_LOSS_TOL, MESH_BF16_*); the context-parallel variant is the
    dense attention route on a slice of C, so it is held to the
    single-device dense route (its gap to the kernel route logged); each
    rank's launches equal the single-device step's; MESH_STEPS steps with
    the dropouts (the loss falls, the parameters bit-identical on every
    rank, ms and peak memory per rank: four ranks share one card, so
    these are not the speeds of a four-card mesh); an eval sweep through
    ShardedEvalContext, its scores held to the single-device scores
    (TOL[bf16]). (b) One rank over NCCL (a 1 x 1 mesh): the plain steps
    held alike, then the CLI with ``--mesh 1,1`` (train_loop's mesh
    branch, a checkpoint, eval_checkpoint over the mesh) against the
    single-device CLI. (c) graft_entry.dryrun_multichip(DRYRUN_RANKS) on
    this card over gloo."""
    from lpformer_tpu_torch import graft_entry, presets
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.parallel import distributed

    cuda = torch.device(dev).type == "cuda"
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    # NCCL puts one rank on a card: the ranks of (a) and (c) share this
    # one over gloo
    rank_dev = "cuda:0" if cuda else "cpu"
    counters = _counters(tabs)
    variants = _mesh_variants()
    # the GCN as the mesh runs it: a COO gather and index_add_
    coo = dataclasses.replace(ds, graph=dataclasses.replace(ds.graph,
                                                            ell=None))
    # single-device references: the step whole (its launches, and a
    # logged witness), and over the COO split as the ranks split the
    # batch (held): a rank's share of the gradient of a bf16-cast weight
    # is rounded to bf16 before the ranks' shares meet, as grad_accum's
    # micro-batches' are (ROADMAP Queue 3)
    whole, refs = {}, {}
    for name, cfg, kw, _ in variants:
        cp = kw.get("context_parallel", False)
        ref_cfg = (dataclasses.replace(cfg, use_pallas_attention=False)
                   if cp else cfg)
        mi = kw.get("mask_input", False)
        whole[name] = _single_step(dev, ds, ref_cfg, batch, mi, counters)
        refs[name] = _single_step(dev, coo, ref_cfg, batch, mi, counters,
                                  micro=MESH_SHAPE[0] if cp else n)
        _compare_steps(f"phase 15 witness {name}: single device over the "
                       f"COO split {MESH_SHAPE[0] if cp else n} ways vs "
                       "whole over the BucketedELL", refs[name][:2],
                       whole[name][:2], whole[name][2], hold=False)
    _compare_steps("phase 15 witness: the dense route vs the kernel route "
                   "(single device, whole)", whole["context_parallel"][:2],
                   whole["plain"][:2], whole["plain"][2], hold=False)
    plain = [v for v in variants if v[0] in ("plain", "plain f32")]
    coo_whole = {name: _single_step(dev, coo, cfg, batch, False, counters)
                 for name, cfg, _, _ in plain}
    _compare_steps("phase 15 witness: the GCN over the COO vs the "
                   "BucketedELL (single device, whole)",
                   coo_whole["plain"][:2], whole["plain"][:2],
                   whole["plain"][2], hold=False)
    train_cfg = presets.COLLAB_LIKE_CONFIG
    spec = dict(data=presets.COLLAB_LIKE_DATA, ppr_cache=ppr_cache,
                mesh=MESH_SHAPE, batch=batch, variants=variants,
                train_cfg=train_cfg, steps=MESH_STEPS)
    t0 = time.perf_counter()
    ranks = distributed.spawn_local(_mesh_rank, n, (spec,), device=rank_dev,
                                    backend="gloo", timeout_s=900)
    shared = (f"; {n} ranks share one card over gloo: not the speed of a "
              f"{n}-card mesh")
    wall = time.perf_counter() - t0
    log(f"phase 15 (a): {n} ranks as a {MESH_SHAPE[0]} x {MESH_SHAPE[1]} "
        f"mesh on {', '.join(sorted({r['device'] for r in ranks}))} over "
        f"{ranks[0]['backend']}, "
        f"{wall:.1f} s in all; host build per rank "
        + ", ".join(f"{r['build_s']:.1f}" for r in ranks)
        + f" s; context rows per rank {ranks[0]['ctx_rows']} of "
        f"{ds.num_nodes}")

    def hold(label, got_loss, got_grads, ref, tols):
        grads = [torch.as_tensor(g, device=dev) for g in got_grads]
        loss_tol, grad_tol = tols
        _, dl, _ = _compare_steps(
            label, (torch.tensor(got_loss, device=dev), grads), ref[:2],
            ref[2], loss_tol, grad_tol, hold=grad_tol is not None)
        if dl > loss_tol:
            raise AssertionError(f"{label}: loss disagrees")
        if grad_tol is None:
            log(f"  the loss held to {loss_tol}: |diff| {dl:.2e}")
            _hold_mesh_bf16(label, got_grads, ref, dev)

    for name, cfg, kw, tols in variants:
        losses = [r["variants"][name]["loss"] for r in ranks]
        if len(set(losses)) != 1:
            raise AssertionError(f"{name}: ranks' losses differ {losses}")
        hold(f"phase 15 (a) {name} (dim {cfg.dim}, batch {batch}, "
             f"{cfg.matmul_dtype}): mesh vs single device over the COO "
             "split alike" + (" (dense route)"
                              if kw.get("context_parallel") else ""),
             losses[0], ranks[0]["variants"][name]["grads"], refs[name],
             tols)
        _hold_rank_launches(name, [r["variants"][name]["launches"]
                                   for r in ranks], whole[name][3], dev)
    if cuda:
        cp = ranks[0]["variants"]["context_parallel"]
        _compare_steps("phase 15 (a) context_parallel vs the single-device "
                       "kernel route (logged)", (torch.tensor(
                           cp["loss"], device=dev), [torch.as_tensor(
                               g, device=dev) for g in cp["grads"]]),
                       whole["plain"][:2], whole["plain"][2], hold=False)

    # training steps: the loss falls, every rank's parameters the same
    losses = ranks[0]["losses"]
    digests = {r["params_digest"] for r in ranks}
    log(f"phase 15 (a) {MESH_STEPS} steps (dropouts on, one batch of "
        f"{batch}): losses " + " ".join(f"{x:.5f}" for x in losses)
        + f"; parameters identical on every rank: {len(digests) == 1}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and len(digests) == 1
            and all(r["losses"] == losses for r in ranks)):
        raise AssertionError("phase 15 (a) training steps failed")
    _hold_rank_launches(f"{MESH_STEPS} steps",
                        [r["train_launches"] for r in ranks],
                        {n_: v * MESH_STEPS
                         for n_, v in whole["plain"][3].items()}, dev)
    for k, r in enumerate(ranks):
        peak = ("not measured" if r["peak_gib"] is None
                else f"{r['peak_gib']:.2f} GiB")
        log(f"  rank {k}: step ms median {statistics.median(r['step_ms']):.1f}"
            f" (min {min(r['step_ms']):.1f}, of {MESH_STEPS} steps incl. "
            f"the first), peak memory {peak}  [{card}{shared}]")

    # the eval sweep
    params = _fresh_params(dev, train_cfg, int(ds.graph.x.shape[1]))
    with torch.no_grad():
        X = lt.propagate(params, train_cfg, ds.graph)
        links = np.concatenate([ds.train_pos_val, ds.valid_pos, ds.test_pos,
                                ds.valid_neg, ds.test_neg])
        want = harness.score_edges(harness.make_score_fn(train_cfg), params,
                                   ds.graph, X, links, batch)
    n_batches = sum(-(-len(s_) // batch) for s_ in (
        ds.train_pos_val, ds.valid_pos, ds.test_pos, ds.valid_neg,
        ds.test_neg))
    _hold_scores("phase 15 (a) eval: the scores over the mesh vs single "
                 "device", [ranks[0]["scores"]], [want],
                 f"; test_standard {ranks[0]['eval_ms']:.1f} ms, "
                 + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}/{v[2]:.4f}"
                             for k, v in ranks[0]["metrics"].items())
                 + f"  [{card}{shared}]")
    if any(r["metrics"] != ranks[0]["metrics"] for r in ranks):
        raise AssertionError("ranks' eval metrics differ")
    want_l = {n_: 0 for n_ in counters}
    want_l[tabs["combined"]["fwd_entry"][0]] = (
        n_batches * train_cfg.trans_layers if cuda else 0)
    _hold_rank_launches("test_standard", [r["eval_launches"] for r in ranks],
                        want_l, dev)

    # (b) one rank over NCCL: a 1 x 1 mesh, the bf16 and f32 plain steps,
    # then the CLI with --mesh 1,1
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    spec_b = dict(spec, mesh=(1, 1), variants=plain, steps=0,
                  nccl_check=cuda, cli=dict(argv=MESH_CLI, ckpt=ckpt_dir))
    t0 = time.perf_counter()
    try:
        one = distributed.spawn_local(_mesh_rank, 1, (spec_b,),
                                      device=rank_dev,
                                      backend="nccl" if cuda else None,
                                      timeout_s=900)[0]
        log(f"phase 15 (b): one rank over {one['backend']} on "
            f"{one['device']}, {time.perf_counter() - t0:.1f} s")
        for name, _, _, tols in plain:
            got = one["variants"][name]
            hold(f"phase 15 (b) {name}, 1 x 1 mesh over {one['backend']}: "
                 "vs single device over the COO", got["loss"], got["grads"],
                 coo_whole[name], tols)
            _hold_rank_launches(f"1 x 1 rank {name}", [got["launches"]],
                                whole[name][3], dev)
        # the single-device CLI: an epoch of its own, and the eval of the
        # mesh's checkpoint
        argv = MESH_CLI + ["--checkpoint-dir", ckpt_dir]
        single = dict(train=_cli_counted(argv + ["--save-as", "single"]),
                      eval=_cli_counted(argv + ["--checkpoint", "mesh"]))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    _hold_mesh_cli(one["cli"], single, one["backend"], dev, card)

    # (c) the JAX dryrun's matrix, every rank on this card
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(DRYRUN_RANKS, device=rank_dev,
                                         backend="gloo")
    for line in lines:
        log(f"  {line}")
    log(f"phase 15 (c): dryrun_multichip({DRYRUN_RANKS}) on one card, "
        f"{time.perf_counter() - t0:.1f} s")
    if not (lines and lines[-1].startswith("dryrun matrix complete")
            and lines[-1].count("(") == 4):
        raise AssertionError("dryrun_multichip failed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--collab-scale", type=float, default=REHEARSAL_SCALE,
                    help="scripts/make_rehearsal_npz.py --scale of phase "
                    "12's npz (1.0: ogbl-collab's size)")
    ap.add_argument("--deterministic-ab", action="store_true",
                    help="time phase 12's step with torch's deterministic "
                    "algorithms on and off, and trace what they swap")
    ap.add_argument("--ppa-only", action="store_true",
                    help="run the build and phase 16 (the ppa-like preset) "
                    "alone; prints no ok line")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    _adopt_orphans()
    try:
        return _run(opts)
    finally:
        _stop_children()


def _run(opts) -> int:
    """Every phase in order; main() stops what is left running after."""
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
    if opts.ppa_only:
        phase_ppa(dev, card, tabs, stamp)
        log(card_line())
        return 0
    # each kernel's entry, and the path whose run counts it
    entries = []
    for layout in tabs:
        entries.append((phase_kernel(dev, layout, tabs[layout]), layout))
        stamp(f"{layout} forward kernel checks")
        entries.append((phase_kernel_bwd(dev, layout, tabs[layout]), layout))
        stamp(f"{layout} backward kernel checks")
        if layout == "combined":
            entries.append((phase_scatter(dev, card), layout))
    phase_key_rows(dev, card)
    stamp("keys by id (phase 17)")
    entries += [(e, "attention A/B") for e in phase_link_attention(dev)]
    stamp("per-link attention kernel checks")
    torch.cuda.empty_cache()
    batch = presets.COLLAB_LIKE_BATCH
    # the collab-like PPR, cached for phase 15's ranks
    ppr_cache = tempfile.mkdtemp(prefix="chip_smoke_ppr_")
    ds = load_dataset(dev, ppr_cache_dir=ppr_cache)
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
    dense = phase_dense(dev, card, ds, tabs, batch)
    log(f"phase 14 summary (collab-like, batch {batch}): " + "; ".join(
        f"{k}: step {v['step']:.3f} ms (forward {v['forward']:.3f}, "
        f"backward {v['backward']:.3f}), peak {v['peak_gib']:.2f} GiB, eval "
        f"batch {v['eval_ms']:.3f} ms" for k, v in dense.items())
        + "; bf16 dense vs kernel gap: " + ", ".join(
            f"{k.split()[0]} loss {v['bf16_loss_gap']:.2e} grads "
            f"{v['bf16_grad_gap']:.2e}" for k, v in dense.items()
            if "bf16_loss_gap" in v) + f"  [{card}]")
    stamp("dense attention route (phase 14)")
    torch.cuda.empty_cache()
    phase_mesh(dev, card, ds, tabs, ppr_cache, batch)
    shutil.rmtree(ppr_cache, ignore_errors=True)
    stamp("the mesh path (phase 15)")
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
    phase_big_spmm(dev, card, ds, cfg.dim, batch)
    phase_citation2_kernels(dev, card, tabs, cfg, batch, ds.num_nodes + 1)
    stamp("citation2-like SpMM and kernel checks")
    phase_citation2_train(dev, card, ds, tabs, cfg, batch)
    stamp("citation2-like training")
    phase_citation2_eval(dev, card, ds, tabs, cfg, batch)
    stamp("citation2-like eval")
    del ds
    torch.cuda.empty_cache()

    phase_ppa(dev, card, tabs, stamp)

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
