"""Smoke run of the PyTorch/CUDA port (lpformer_tpu_torch) on one H100.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the five CUDA libraries (nvcc, sm_90a: the fused
     PE+attention forward and backward of each context-table layout, the
     scatter-add) and the PPR push library (g++) from the checkout's
     sources, all at once;
  3. kernels: each kernel against its plain torch version on the card at
     its main-path shape, the PE+attention pairs in bf16 and in f32, with
     CUDA-event times, the work's bound and, for the scatter, the one-call
     torch yardstick ``index_add_``: the combined table's pair at B=4096,
     C=128, O=dh=128, K=3; the classic table's pair at B=4096, C=320
     (blocks 64 | 128 | 128), O=dh=128, K=3; the scatter over [4096, 128]
     rows into 50,001;
then, for each table layout of the collab-like preset (presets.py: the
combined table of budget 128, then the classic per-class table of budgets
64 / 128 / 128):
  4. eval path: the collab-like synthetic dataset (50k nodes, 400k edges),
     random weights from a fixed seed, propagate once and score the eval
     sets in batches of 4096 through test_standard; the layout's forward
     kernel launch count must equal the number of score batches, every
     eval link's score must be finite, and one batch's scores must match
     the port's plain path on the card;
  5. train path: one step with dropout off and fixed negatives, whose loss
     and every gradient leaf through the kernels must match the plain
     versions on the card; then train_loop for one epoch of batches of
     4096 with the default dropouts and one test_standard at its end:
     every loss finite, metrics in [0, 1], and the launch counts of all
     five kernels equal to the path's calls (the other layout's kernels
     at 0); then the median step time, split into forward, backward and
     optimizer, and the step's peak memory;
then a "kernels:" summary line and a JSON line of per-kernel numbers (each
kernel's launches from the train_loop run of its layout's path), the card
line again, and as the last line {"ok": true, "device": {...}}. Any
failure exits nonzero before that line. Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lpformer_tpu_torch.utils import measure
from lpformer_tpu_torch.utils.measure import (
    bwd_inputs, card_line, scatter_bound_ms, scatter_inputs, time_ms,
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
# Scatter kernel vs plain: f32 sums in another order; an element's error is
# at most (k - 1) 2^-24 sum|terms| for k terms, and the hub rows here take
# thousands, so max |err| is held to 1e-4 of the largest row abs-sum.
SCATTER_TOL = 1e-4
# One training step through the kernels vs through the plain versions, both
# bf16 at the collab-like shape: |loss difference| and, per gradient leaf,
# ||kernel - plain|| / ||plain|| (the bf16 rounding flips above, carried
# through the model's backward; a wrong kernel output is O(1)).
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-3, 2e-2


def log(*a):
    print(*a, flush=True)


def tables():
    """The two context-table layouts, each with its fused op's kernel pair:
    wrappers, plain versions, main-path inputs and bounds, the name the
    model calls the op by, and the JSON entries' fixed fields."""
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
    from lpformer_tpu_torch.ops import pe_attention as pa
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam
    from lpformer_tpu_torch.ops import scatter

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as ex:
        futs = [ex.submit(f) for f in (pam.build, pam.build_bwd, pa.build,
                                       pa.build_bwd, scatter.build)]
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


def phase_kernel(dev, layout, t):
    """A layout's forward kernel vs plain at its main-path shape; returns
    the JSON entry."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        a = t["inputs"](dev, dtype)
        got = t["op"](**a)
        torch.cuda.synchronize()
        want = t["plain"](**a)
        errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        mean_err = float((got[0] - want[0]).abs().mean())
        rel_l = float(((got[2] - want[2]).abs()
                       / want[2].abs().clamp_min(1.0)).max())
        tol, tol_mean = TOL[dtype]
        ok_ = (errs[0] <= tol and errs[1] <= tol and rel_l <= tol
               and mean_err <= tol_mean
               and bool(torch.isfinite(got[0]).all()))
        # 20 back-to-back launches per timing, so the wrapper's host
        # overhead overlaps the previous launch's device work
        ms = time_ms(lambda: t["op"](**a), 10, per=20)
        plain_ms = time_ms(lambda: t["plain"](**a), 5, 1)
        bound, bound_by, nv = t["bound"](a)
        log(f"kernel {layout} {str(dtype)[6:]}: max|out| err {errs[0]:.3e} "
            f"(mean {mean_err:.3e}), max|m| err {errs[1]:.3e}, max rel l "
            f"err {rel_l:.3e} (tol {tol}, mean {tol_mean}); {nv} valid slots "
            f"of {a['valid'].numel()}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
        if not ok_:
            raise AssertionError(f"{layout} kernel disagrees with plain in "
                                 f"{dtype}")
        if dtype == torch.bfloat16:
            entry = _entry(t["fwd_entry"], max(errs[0], errs[1]), ms,
                           plain_ms, bound, bound_by)
    return entry


def _rel_errs(got, want):
    """(max |err| / max |want|, mean |err| / mean |want|) in f32."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return (float(d.max() / w.max().clamp_min(1e-30)),
            float(d.mean() / w.mean().clamp_min(1e-30)))


def phase_kernel_bwd(dev, layout, t):
    """A layout's PE+attention backward kernels vs their plain version at
    its main-path shape; returns the JSON entry."""
    names = ("dkeys", "dq", "dw1cat", "dg", "db", "dw2", "dcb", "datt")
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        a = bwd_inputs(t["inputs"](dev, dtype))
        got = t["bwd"](**a)
        torch.cuda.synchronize()
        want = t["bwd_plain"](**a)
        tol, tol_mean = BWD_TOL[dtype]
        errs = {n: _rel_errs(x, y) for n, x, y in zip(names, got, want)}
        ok_ = all(e[0] <= tol and e[1] <= tol_mean for e in errs.values())
        ok_ &= all(bool(torch.isfinite(x.float()).all()) for x in got)
        ok_ &= got[0].dtype == a["keys"].dtype
        max_abs = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(got, want))
        ms = time_ms(lambda: t["bwd"](**a), 10, per=10)
        plain_ms = time_ms(lambda: t["bwd_plain"](**a), 3, 1)
        bound, bound_by, nv = t["bwd_bound"](a)
        log(f"kernel bwd {layout} {str(dtype)[6:]}: " + ", ".join(
            f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in errs.items())
            + f" (max/mean rel err; tol {tol}/{tol_mean}); max abs err "
            f"{max_abs:.3e}; {nv} valid slots; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
        if not ok_:
            raise AssertionError(f"{layout} backward kernel disagrees with "
                                 f"plain in {dtype}")
        if dtype == torch.bfloat16:
            entry = _entry(t["bwd_entry"], max_abs, ms, plain_ms, bound,
                           bound_by)
    return entry


def phase_scatter(dev):
    """The scatter-add kernel vs its plain version at the main-path shape,
    with the one-call torch yardstick; returns the JSON entry."""
    from lpformer_tpu_torch.ops import scatter

    ids, ct, n, live = scatter_inputs(dev)
    got = scatter.scatter_rows_add(ids, ct, n, live)
    torch.cuda.synchronize()
    want = scatter.scatter_rows_add_plain(ids, ct, n, live)
    abs_sum = scatter.scatter_rows_add_plain(ids, ct.float().abs(), n, live)
    err = float((got - want).abs().max())
    scale = float(abs_sum.max())
    ms = time_ms(lambda: scatter.scatter_rows_add(ids, ct, n, live), 10,
                 per=10)
    plain_ms = time_ms(
        lambda: scatter.scatter_rows_add_plain(ids, ct, n, live), 5, 1)
    flat_ids = ids.reshape(-1).long()
    flat_ct = ct.reshape(-1, ct.shape[-1])
    lib_ms = time_ms(lambda: torch.zeros(
        (n, ct.shape[-1]), device=dev).index_add_(0, flat_ids,
                                                  flat_ct.float()), 10, per=10)
    bound, bound_by, nl = scatter_bound_ms(ids, ct, n, live)
    log(f"kernel scatter: max abs err {err:.3e} (tol {SCATTER_TOL} x max "
        f"row abs-sum {scale:.1f}); {nl} live rows of {ids.numel()}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
    if err > SCATTER_TOL * scale or not bool(torch.isfinite(got).all()):
        raise AssertionError("scatter kernel disagrees with plain")
    return _entry(("scatter_rows_add",
                   "lpformer_tpu_torch/csrc/scatter_rows_add.cu",
                   "lpformer_tpu/ops/pallas/scatter.py:48"),
                  err, ms, plain_ms, bound, bound_by, lib_ms)


def load_dataset(dev, data=None):
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.data.synthetic import synthetic_dataset

    data = data or presets.COLLAB_LIKE_DATA
    t0 = time.perf_counter()
    ds = synthetic_dataset(**data, device=dev)
    log(f"dataset: {time.perf_counter() - t0:.1f} s host build "
        f"({ds.num_nodes} nodes, {ds.graph.num_edges} directed edges)")
    return ds


def phase_main(dev, card, ds, layout, t, batch=None):
    """The eval path end to end at the collab-like preset of a table
    layout (presets.py); returns the forward kernel's launch count."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.evalx import harness
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops.context import extract_context

    cfg = t["cfg"]
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
    from lpformer_tpu_torch.ops import scatter

    out = {"scatter_rows_add": scatter.scatter_rows_add}
    for t in tabs.values():
        out[t["fwd_entry"][0]] = t["op"]
        out[t["bwd_entry"][0]] = t["bwd"]
    return out


def phase_train(dev, card, ds, layout, tabs, batch=None, epochs=1,
                timed_steps=10):
    """The training path at the collab-like preset of a table layout;
    returns each kernel's launch count in the train_loop run."""
    from lpformer_tpu_torch import presets
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.train import optim, step as step_mod, trainer
    from lpformer_tpu_torch.utils.logger import ResultsLogger

    t = tabs[layout]
    cfg = t["cfg"]
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
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    log(f"train step {layout} kernels vs plain: loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f} (|diff| {dl:.2e}, tol {STEP_LOSS_TOL}); "
        f"grad leaves {len(rel)}, max rel L2 err {max(rel):.2e} (median "
        f"{statistics.median(rel):.2e}, tol {STEP_GRAD_TOL})")
    if dl > STEP_LOSS_TOL or max(rel) > STEP_GRAD_TOL or not finite:
        raise AssertionError("training step through the kernels disagrees "
                             "with the plain path")

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
    log(f"train_loop {layout}: {epochs} epoch(s), {len(losses)} steps of "
        f"{batch}, {wall:.1f} s wall incl. one test_standard; loss first "
        f"{float(lv[0]):.4f} last {float(lv[-1]):.4f} mean "
        f"{float(lv.mean()):.4f}; " + ", ".join(
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
    log(f"train step {layout} (median of {timed_steps}, batch {batch}): "
        f"{total:.3f} ms = forward {fwd:.3f} + backward {bwd:.3f} + "
        f"optimizer {upd_ms:.3f}; {batch / total * 1e3:.0f} positive links/s"
        f"; peak memory of the timed steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    log(f"device: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_build()
    tabs = tables()
    # each kernel's entry, and the layout whose train_loop run counts it
    entries = [(phase_kernel(dev, "combined", tabs["combined"]), "combined"),
               (phase_kernel_bwd(dev, "combined", tabs["combined"]),
                "combined"),
               (phase_scatter(dev), "combined"),
               (phase_kernel(dev, "classic", tabs["classic"]), "classic"),
               (phase_kernel_bwd(dev, "classic", tabs["classic"]),
                "classic")]
    ds = load_dataset(dev)
    launches = {}
    for layout in tabs:
        phase_main(dev, card, ds, layout, tabs[layout])
        launches[layout] = phase_train(dev, card, ds, layout, tabs)
    for e, layout in entries:
        e["launches"] = launches[layout][e["name"]]
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
