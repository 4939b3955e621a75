"""Smoke run of the PyTorch/CUDA port (lpformer_tpu_torch) on one H100.

    python3 chip_smoke.py

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
then a "kernels:" summary line and a JSON line of per-kernel numbers (each
kernel's launches from its path's run: rows 1-3 the collab-like combined
train_loop, rows 4-5 the classic one, rows 6-7 phase 7, row 8 phase 6),
the card line again, and as the last line {"ok": true, "device": {...}}.
Any failure exits nonzero before that line. Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
import os
import statistics
import sys
import time
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


def phase_kernel(dev, layout, t):
    """A layout's forward kernel vs plain at its main-path shape and its
    wider shapes; returns the JSON entry (main shape, bf16)."""
    entry = None
    t["module"]._load()
    for dtype, shape, kw in _runs(t):
        a = t["inputs"](dev, dtype, **kw)
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
               and mean_err <= tol_mean
               and bool(torch.isfinite(got[0]).all()))
        # 20 back-to-back launches per timing, so the wrapper's host
        # overhead overlaps the previous launch's device work (fewer at the
        # wider shapes, whose launches are long)
        ms = (time_ms(lambda: t["op"](**a), 10, per=20) if shape == "main"
              else time_ms(lambda: t["op"](**a), 3, per=2))
        plain_ms = (time_ms(lambda: t["plain"](**a), 5, 1)
                    if shape == "main" else None)
        bound, bound_by, nv = t["bound"](a)
        log(f"kernel {layout} {str(dtype)[6:]} {shape} ({_shape(a)}): "
            f"max|out| err {errs[0]:.3e} (mean {mean_err:.3e}), max|m| err "
            f"{errs[1]:.3e}, max rel l err {rel_l:.3e} (tol {tol}, mean "
            f"{tol_mean}); {nv} valid slots of {a['valid'].numel()}; kernel "
            f"{ms:.4f} ms, plain "
            + ("not timed" if plain_ms is None else f"{plain_ms:.4f} ms")
            + f", bound {bound:.5f} ms ({bound_by})")
        if not ok_:
            raise AssertionError(f"{layout} kernel disagrees with plain in "
                                 f"{dtype} at {shape}")
        if dtype == torch.bfloat16 and shape == "main":
            entry = _entry(t["fwd_entry"], max(errs[0], errs[1]), ms,
                           plain_ms, bound, bound_by)
        del a, got, want
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


def phase_kernel_bwd(dev, layout, t):
    """A layout's PE+attention backward kernels vs their plain version at
    its main-path shape and its wider shapes; returns the JSON entry."""
    names = ("dkeys", "dq", "dw1cat", "dg", "db", "dw2", "dcb", "datt")
    entry = None
    t["module"]._load_bwd()
    for dtype, shape, kw in _runs(t):
        a = bwd_inputs(t["inputs"](dev, dtype, **kw))
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
                                   names, got, want, dtype, a["keys"].dtype)
        ms = (time_ms(lambda: t["bwd"](**a), 10, per=10) if shape == "main"
              else time_ms(lambda: t["bwd"](**a), 3, per=2))
        plain_ms = (time_ms(lambda: t["bwd_plain"](**a), 3, 1)
                    if shape == "main" else None)
        bound, bound_by, nv = t["bwd_bound"](a)
        log(f"kernel bwd {layout} {str(dtype)[6:]} {shape} ({_shape(a)}): "
            f"{text}; {nv} valid slots; kernel {ms:.4f} ms, plain "
            + ("not timed" if plain_ms is None else f"{plain_ms:.4f} ms")
            + f", bound {bound:.5f} ms ({bound_by})")
        if dtype == torch.bfloat16 and shape == "main":
            entry = _entry(t["bwd_entry"], max_abs, ms, plain_ms, bound,
                           bound_by)
        del a, got, want
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
        links = links[:batch]
        tl = torch.as_tensor(links, dtype=torch.int64, device=dev)
        src, tgt = tl[:, 0], tl[:, 1]
        scores = score_fn(params, ds.graph, X, src, tgt)
        if scores.shape != (len(links),) or not torch.isfinite(scores).all():
            raise AssertionError("scores not finite or of the wrong shape")
        orig = getattr(lt, t["model_op"])
        setattr(lt, t["model_op"], t["plain"])
        try:
            plain = score_fn(params, ds.graph, X, src, tgt)
        finally:
            setattr(lt, t["model_op"], orig)
        err = float((scores - plain).abs().max())
        log(f"scores {layout} kernel vs plain path: max abs err {err:.3e} "
            f"(tol {SCORE_TOL})")
        if err > SCORE_TOL:
            raise AssertionError("kernel path disagrees with the plain path")

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


def phase_train(dev, card, ds, layout, tabs, cfg=None, batch=None, epochs=1,
                timed_steps=5):
    """The training path at a preset of a table layout; returns each
    kernel's launch count in the train_loop run."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.train import optim, step as step_mod, trainer
    from lpformer_tpu_torch.utils.logger import ResultsLogger

    t = tabs[layout]
    cfg = cfg or t["cfg"]
    batch = batch or presets.COLLAB_LIKE_BATCH
    in_dim = int(ds.graph.x.shape[1])
    mult = ds.mask_mult_device

    def fresh_params(c):
        p = lt.init_lpformer(torch.Generator().manual_seed(0), c,
                             in_dim=in_dim, device=dev)
        for x in optim.tree_leaves(p):
            x.requires_grad_(True)
        return p

    # (a) one step, dropout off, fixed negatives: kernels vs plain versions
    nodrop = dataclasses.replace(cfg, dropout=0.0, gnn_drop=0.0,
                                 att_drop=0.0)
    params = fresh_params(nodrop)
    leaves = optim.tree_leaves(params)
    pos = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    neg = torch.randint(0, ds.num_nodes, (2, batch),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    w = torch.ones(batch, device=dev)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  mult, weight=w)

    def loss_and_grads():
        loss = step_mod.loss_fn(params, nodrop, ds.graph, pos[:, 0],
                                pos[:, 1], neg[0], neg[1], w, mr, None)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads()
    restore = _plain_training_path(tabs)
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        restore()
    dl = abs(float(loss_k) - float(loss_p))
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
           for a, b in zip(grads_k, grads_p)]
    worst = [p for p, _ in optim.tree_leaves_with_path(params)][
        rel.index(max(rel))]
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    log(f"train step {layout} (dim {cfg.dim}) kernels vs plain: loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f} (|diff| {dl:.2e}, tol "
        f"{STEP_LOSS_TOL}); grad leaves {len(rel)}, max rel L2 err "
        f"{max(rel):.2e} at {'/'.join(map(str, worst))} (median "
        f"{statistics.median(rel):.2e}, tol {STEP_GRAD_TOL})")
    if dl > STEP_LOSS_TOL or max(rel) > STEP_GRAD_TOL or not finite:
        raise AssertionError("training step through the kernels disagrees "
                             "with the plain path")
    del params, leaves, grads_k, grads_p

    # (b) the main path: train_loop, one test_standard at its end
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

    # (c) where a step's time goes: CUDA events around its three stages
    params = fresh_params(cfg)
    opt = optim.make_optimizer(1e-3, steps_per_epoch=steps)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(timed_steps + 2):
        links = torch.as_tensor(
            ds.train_pos[i * batch:(i + 1) * batch]).to(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        negs = torch.randint(0, ds.num_nodes, (2, batch), generator=gen,
                             device=dev, dtype=links.dtype)
        mr = masking.batch_mask_ranks(ds.graph.adj_rows, links[:, 0],
                                      links[:, 1], mult, weight=w)
        loss = step_mod.loss_fn(params, cfg, ds.graph, links[:, 0],
                                links[:, 1], negs[0], negs[1], w, mr, gen)
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
        if i >= 2:
            times.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    fwd, bwd, upd_ms = (statistics.median(x[j] for x in times)
                        for j in range(3))
    total = statistics.median(sum(x) for x in times)
    log(f"train step {layout} (dim {cfg.dim}; median of {timed_steps}, "
        f"batch {batch}): {total:.3f} ms = forward {fwd:.3f} + backward "
        f"{bwd:.3f} + optimizer {upd_ms:.3f}; {batch / total * 1e3:.0f} "
        f"positive links/s; peak memory of the timed steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    return launches


def main() -> int:
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
    del ds

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
