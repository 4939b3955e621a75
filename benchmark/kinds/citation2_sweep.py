"""Whole ogbl-citation2 evaluations back to back: one propagation, then a
valid and a test split, each positive's source scored against its own
negative targets in batches of ``test_batch_size``, then the MRR.

Set-up runs one whole sweep; the window runs sweeps until its time is up.
The check, after the window, compares the last sweep's outputs:

  * ``score_gap``: the scores of ``positives_checked`` positives of each
    split, drawn from the seed, with all their negatives, against the
    reference's, which pushes the PPR row of every endpoint of those links
    itself;
  * ``mrr_gap``: the MRRs the sweep returned against OGB's rank formula on
    the sweep's own scores of every link;
  * ``ppr_gap``: the reference's PPR rows of those endpoints against the
    program's.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from lpbench import cells, program
from lpbench import data as data_mod
from lpbench.trace import Trace
from reference import model as ref_model
from reference import params as ref_params
from reference.graph import rows_csr

# "half": the second half of each batch's scores read 0; "answer": each
# batch's first score altered; "mrr": the returned valid and test MRRs
# swapped
FAULTS = ("half", "answer", "mrr")


def traffic(run: cells.Run, seed: int, graph, mask):
    """(sub-seeds, splits, the program's dataset, weights) of ``seed``."""
    cfg, tr = run.cfg, run.traffic
    seeds = data_mod.sub_seeds(seed)
    splits = data_mod.citation2_links(
        cfg["num_nodes"], tr["positives_per_split"],
        tr["negatives_per_positive"], cfg["power"], seeds["links"])
    ds = program.citation2_dataset(cfg, graph, mask, splits)
    P = ref_params.make_weights(cfg, cfg["_data"]["x"].shape[1],
                                seeds["weights"], run.device)
    return seeds, splits, ds, P


def outputs(scores: list, splits) -> dict:
    """The sweep's recorded scores by split: positives [P], negatives
    [P * K] (told apart by size)."""
    p = len(splits[0][0])
    return {"pos": [s for s in scores if s.size == p],
            "neg": [s for s in scores if s.size != p]}


def swapped(res: dict) -> dict:
    t, v, s = res["MRR"]
    return {"MRR": (t, s, v)}


def run(run: cells.Run, seed: int, seconds: float, trace: bool, faults,
        precision: str, t_start: float) -> dict:
    cfg, dev = run.cfg, run.device
    graph, ppr, mask, run.host_build_s = program.build_graph(
        cfg, cfg["_data"], dev)
    seeds, splits, ds, P = traffic(run, seed, graph, mask)
    per_sweep = sum(len(p) + nt.size for p, nt in splits)
    with program.recording_scores() as scores, _fault(faults):
        res = program.citation2_sweep(cfg, P, ds)
        cells.sync(dev)
        run.setup_s = time.perf_counter() - t_start
        tracer = Trace() if trace else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ctx = (program.recording_pe_attention() if trace
               else contextlib.nullcontext([]))
        with ctx as calls:
            with (tracer.window(dev) if trace else contextlib.nullcontext()):
                t0 = time.perf_counter()
                while True:
                    scores.clear()
                    res = program.citation2_sweep(cfg, P, ds)
                    run.units += 1
                    if time.perf_counter() - t0 >= seconds:
                        break
                cells.sync(dev)
                run.window_s = time.perf_counter() - t0
    run.links = run.units * per_sweep
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    got = outputs(scores, splits)
    run.failed = sum(int((~np.isfinite(s)).sum() > 0) for s in scores)
    if trace:
        run.trace = tracer.reduce()
        run.pe_calls = [(k, w1, kb, int(nv), bwd)
                        for k, w1, kb, nv, bwd in calls]

        def prop():
            with torch.no_grad():
                program.propagate(cfg, P, graph)

        run.spans["propagate_eval_s"] = cells.event_s(prop, dev)
    del graph, ds, calls
    cells.free(dev)
    g = cells.reference_graph(cfg, dev)
    run.num_entries = g.a_hat._nnz()
    return check(run, g, ppr, P, splits, seeds, got, res, precision)


def check(run: cells.Run, g, ppr, P, splits, seeds, got: dict, res: dict,
          precision: str) -> dict:
    """The compared numbers of one sweep's outputs ``got`` (its scores)
    and ``res`` (its returned MRRs). A ``precision`` below the
    configuration's puts the reference at it in the program's place (the
    control): its PPR push in float32, its products at ``precision``."""
    cfg, tr = run.cfg, run.traffic
    stated = cfg["matmul_dtype"]
    rows = checked_rows(splits, tr["positives_checked"], seeds["links"] + 2)
    nodes = checked_nodes(splits, rows)
    exact = cells.timed(run, "check_push_s", g.push, nodes, cfg["alpha"],
                        cfg["eps"])
    g.use_rows(exact)
    refs, slots = cells.timed(run, "check_scores_s", eval_reference, cfg, g,
                              P, splits, stated, rows)
    run.slots["eval"] = slots
    prog_ppr = (ppr.indptr, ppr.indices, ppr.weights)
    mrr = mrr_gap(res, got)
    if precision != stated:
        low = g.push(nodes, cfg["alpha"], cfg["eps"], np.float32)
        g.use_rows(low)
        ctl, _ = eval_reference(cfg, g, P, splits, precision, rows)
        got = {k: [c[k].cpu().numpy() for c in ctl] for k in ("pos", "neg")}
        rows = [np.arange(len(r)) for r in rows]
        prog_ppr = rows_csr(low, g.n)
        mrr = 0.0   # the reference's own rank formula in the program's place
    nums = compare_eval(got, refs, rows)
    nums["mrr_gap"] = mrr
    nums["ppr_gap"] = cells.ppr_gap(exact, *prog_ppr)
    return nums


def checked_rows(splits, count: int, seed: int) -> list:
    """The positives whose scores the check compares: ``count`` of each
    split, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(len(p), min(count, len(p)), replace=False))
            for p, _ in splits]


def checked_nodes(splits, rows) -> np.ndarray:
    """Every endpoint of the checked links: the checked positives' sources
    and targets and all their negative targets."""
    return np.unique(np.concatenate(
        [np.concatenate([pos[r].reshape(-1), negt[r].reshape(-1)])
         for (pos, negt), r in zip(splits, rows)]))


def eval_reference(cfg, g, P, splits, precision: str, checked: list):
    """The reference's scores of the checked positives of each split and
    of their negatives; and the mean valid context slots of those links."""
    model = ref_model.Model(cfg, g, precision)
    dev = g.device
    refs = [ref_model.citation2_scores(
        model, P, torch.as_tensor(pos[rows]).to(dev),
        torch.as_tensor(negt[rows]).to(dev), cfg["test_batch_size"])
        for (pos, negt), rows in zip(splits, checked)]
    links = sum(len(r) * (1 + negt.shape[1])
                for (_, negt), r in zip(splits, checked))
    return refs, float(model.slots) / max(links, 1)


def compare_eval(got: dict, refs: list, checked: list) -> dict:
    """The largest gap of any checked score: the positives ``checked`` [i]
    of split i with all their negatives."""
    gap = 0.0
    for i, (r, rows) in enumerate(zip(refs, checked)):
        if i >= len(got["pos"]) or i >= len(got["neg"]):
            return {"score_gap": float("inf")}
        k = r["neg"].shape[1]
        for kind, a in (("pos", got["pos"][i][rows]),
                        ("neg", got["neg"][i].reshape(-1, k)[rows]
                         if got["neg"][i].size % k == 0 else None)):
            b = r[kind].double().cpu().numpy()
            a = None if a is None else np.asarray(a, np.float64)
            ok = a is not None and a.shape == b.shape and np.isfinite(a).all()
            gap = max(gap, float(np.abs(a - b).max()) if ok else float("inf"))
    return {"score_gap": gap}


def mrr_gap(res: dict, got: dict) -> float:
    """The largest gap between the sweep's returned MRRs (train, valid,
    test; its train MRR is the valid split's, as the LPFormer reference
    has it) and OGB's rank formula on the sweep's own scores."""
    if len(got["pos"]) < 2 or len(got["neg"]) < 2:
        return float("inf")
    want = []
    for pos, neg in zip(got["pos"], got["neg"]):
        if neg.size % max(pos.size, 1):
            return float("inf")
        want.append(ref_model.mrr(pos, neg.reshape(pos.size, -1)))
    want = (want[0], want[0], want[1])
    return max(abs(float(a) - b) for a, b in zip(res["MRR"], want))


def calibrate(run: cells.Run, seeds: list, controls: int, emit) -> None:
    """Each seed's sound readings from one whole sweep; on the first
    ``controls`` seeds the control's and the swapped MRRs' readings. One
    host build serves every seed."""
    cfg, dev = run.cfg, run.device
    stated = cfg["matmul_dtype"]
    graph, ppr, mask, host_s = program.build_graph(cfg, cfg["_data"], dev)
    g = cells.reference_graph(cfg, dev)
    emit("setup", None, {"host_build_s": host_s})
    for i, seed in enumerate(seeds):
        sd, splits, ds, P = traffic(run, seed, graph, mask)
        with program.recording_scores() as scores:
            res = program.citation2_sweep(cfg, P, ds)
        got = outputs(scores, splits)
        run.spans = {}
        emit("sound", seed, dict(
            check(run, g, ppr, P, splits, sd, got, res, stated),
            slots=run.slots["eval"], **run.spans))
        if i < controls:
            emit("control", seed, check(run, g, ppr, P, splits, sd, got,
                                        res, cells.CONTROL[stated]))
            emit("mrr", seed, {"mrr_gap": mrr_gap(swapped(res), got)})
        del ds, P, got, scores
        cells.free(dev)


def _fault(faults):
    """The sweep with the planted ``faults`` (see FAULTS)."""
    if not faults:
        return contextlib.nullcontext()
    from lpformer_tpu_torch.evalx import harness

    real, real_mrr = harness.make_score_fn, harness.metrics.\
        get_metric_score_citation2

    def make(cfg):
        fn = real(cfg)

        def faulty(params, graph, X, src, tgt):
            out = fn(params, graph, X, src, tgt)
            if "half" in faults:
                out = torch.cat([out[: len(out) // 2],
                                 torch.zeros_like(out[len(out) // 2:])])
            if "answer" in faults:
                out = out.clone()
                out[0] = 1.0 - out[0]
            return out

        return faulty

    def mrr(*a):
        return swapped(real_mrr(*a)) if "mrr" in faults else real_mrr(*a)

    @contextlib.contextmanager
    def patched():
        harness.make_score_fn = make
        harness.metrics.get_metric_score_citation2 = mrr
        try:
            yield
        finally:
            harness.make_score_fn = real
            harness.metrics.get_metric_score_citation2 = real_mrr

    return patched()
