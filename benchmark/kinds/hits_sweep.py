"""Whole shared-negative evaluations back to back, as ogbl-ppa's
(``evalx/harness.py:test_standard``, the LPFormer reference's
``testing.py:test``): one propagation, then the ``train_pos_val``, valid
and test positives and the valid and test shared negatives, in that order
and in batches of ``test_batch_size``, scored by Hits@20/50/100 (the train
positives against the valid negatives).

Traffic from the seed: ``positives_per_split`` positives for each of the
three positive splits (``train_pos_val`` a sample of the train edges;
valid and test power-law endpoints, as the graph's edges) and
``negatives_per_positive`` times as many uniform pairs for each of the two
negative splits.

Set-up runs one whole sweep; the window runs sweeps until its time is up.
The check, after the window, compares the last sweep's outputs:

  * ``score_gap``: the scores of ``positives_checked`` links of each
    positive split and ``negatives_checked`` of each negative split, drawn
    from the seed, against the reference's, which pushes the PPR row of
    every endpoint of those links itself;
  * ``hits_gap``: the Hits the sweep returned against OGB's formula on the
    sweep's own scores of every link;
  * ``ppr_gap``: the reference's PPR rows of those endpoints against the
    program's.

A run reports its kind as ``citation2_sweep``, the name by which the
evaluation readers (``metrics/eval_links_per_s.py``,
``metrics/eval_mfu.py``) know an evaluation cell. A traced run's mean
valid context slots a link, which ``eval_mfu`` counts the work by, is the
program's counter ``context.valid_slots`` over the window's links, not the
checked links' sample. The program's entry
points this kind needs beside ``lpbench/program.py``'s are here, with
their imports inside the functions.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from lpbench import cells, program, spans
from lpbench import data as data_mod
from lpbench.trace import Trace
from reference import model as ref_model
from reference import params as ref_params
from reference.graph import rows_csr

K_LIST = (20, 50, 100)
# the sweep's splits in its order: (name, positive)
SPLITS = (("train_pos_val", True), ("valid_pos", True), ("test_pos", True),
          ("valid_neg", False), ("test_neg", False))

# "half": the second half of each batch's scores read 0; "answer": each
# batch's first score altered; "hits": the returned valid and test Hits
# swapped
FAULTS = ("half", "answer", "hits")


def hits_links(cfg: dict, tr: dict, seed: int) -> list:
    """The five splits' links [M, 2] in the sweep's order, from ``seed``."""
    rng = np.random.default_rng(seed)
    n, p = cfg["num_nodes"], tr["positives_per_split"]
    edges = cfg["_data"]["edges"]
    train = edges[rng.choice(len(edges), p, replace=len(edges) < p)]
    valid = data_mod.random_edges(rng, n, p, cfg["power"])
    test = data_mod.random_edges(rng, n, p, cfg["power"])
    m = p * tr["negatives_per_positive"]
    return [train, valid, test, rng.integers(0, n, (m, 2)),
            rng.integers(0, n, (m, 2))]


def standard_dataset(cfg: dict, graph, mask, links):
    from lpformer_tpu_torch.data.dataset import LinkPredDataset
    return LinkPredDataset(
        name=cfg["name"], num_nodes=cfg["num_nodes"], graph=graph,
        graph_test=graph, train_pos=np.zeros((1, 2), np.int64),
        train_pos_val=links[0], valid_pos=links[1], test_pos=links[2],
        valid_neg=links[3], test_neg=links[4], metric="Hits@100",
        mask_uniq_keys=mask[0], mask_mult=mask[1])


def standard_sweep(cfg: dict, params, ds):
    """One whole evaluation: propagate, score the five splits in batches of
    ``test_batch_size``, Hits@K. Returns {"Hits@K": (train, valid,
    test)}."""
    from lpformer_tpu_torch.evalx import harness
    return harness.test_standard(params, program.model_config(cfg), ds,
                                 batch_size=cfg["test_batch_size"],
                                 k_list=K_LIST)


def traffic(run: cells.Run, seed: int, graph, mask):
    """(sub-seeds, links, the program's dataset, weights) of ``seed``."""
    cfg = run.cfg
    seeds = data_mod.sub_seeds(seed)
    links = hits_links(cfg, run.traffic, seeds["links"])
    ds = standard_dataset(cfg, graph, mask, links)
    P = ref_params.make_weights(cfg, cfg["_data"]["x"].shape[1],
                                seeds["weights"], run.device)
    return seeds, links, ds, P


def run(run: cells.Run, seed: int, seconds: float, trace: bool, faults,
        precision: str, t_start: float) -> dict:
    cfg, dev = run.cfg, run.device
    graph, ppr, mask, run.host_build_s = program.build_graph(
        cfg, cfg["_data"], dev)
    seeds, links, ds, P = traffic(run, seed, graph, mask)
    with program.recording_scores() as scores, _fault(faults):
        res = standard_sweep(cfg, P, ds)
        cells.sync(dev)
        run.setup_s = time.perf_counter() - t_start
        tracer = Trace() if trace else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ctx = (program.recording_pe_attention() if trace
               else contextlib.nullcontext([]))
        valid0 = spans.counter("context.valid_slots")
        with ctx as calls:
            with (tracer.window(dev) if trace else contextlib.nullcontext()):
                t0 = time.perf_counter()
                while True:
                    scores.clear()
                    res = standard_sweep(cfg, P, ds)
                    run.units += 1
                    if time.perf_counter() - t0 >= seconds:
                        break
                cells.sync(dev)
                run.window_s = time.perf_counter() - t0
    run.kind = "citation2_sweep"
    run.links = run.units * sum(len(x) for x in links)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    got = list(scores)
    run.failed = sum(int((~np.isfinite(s)).sum() > 0) for s in got)
    if trace:
        run.trace = tracer.reduce()
        run.pe_calls = [(k, w1, kb, int(nv), bwd)
                        for k, w1, kb, nv, bwd in calls]
        valid = spans.counter("context.valid_slots")
        if valid is not None:
            run.slots["eval"] = (valid - (valid0 or 0)) / run.links

        def prop():
            with torch.no_grad():
                program.propagate(cfg, P, graph)

        run.spans["propagate_eval_s"] = cells.event_s(prop, dev)
    del graph, ds, calls
    cells.free(dev)
    g = cells.reference_graph(cfg, dev)
    run.num_entries = g.a_hat._nnz()
    return check(run, g, ppr, P, links, seeds, got, res, precision)


def check(run: cells.Run, g, ppr, P, links, seeds, got: list, res: dict,
          precision: str) -> dict:
    """The compared numbers of one sweep's outputs ``got`` (its scores of
    the five splits) and ``res`` (its returned Hits). A ``precision``
    below the configuration's puts the reference at it in the program's
    place (the control): its PPR push in float32, its products at
    ``precision``."""
    cfg, tr = run.cfg, run.traffic
    stated = cfg["matmul_dtype"]
    rows = checked_rows(links, tr, seeds["links"] + 2)
    nodes = np.unique(np.concatenate(
        [x[r].reshape(-1) for x, r in zip(links, rows)]))
    exact = cells.timed(run, "check_push_s", g.push, nodes, cfg["alpha"],
                        cfg["eps"])
    g.use_rows(exact)
    refs, slots = cells.timed(run, "check_scores_s", reference_scores, cfg,
                              g, P, links, rows, stated)
    run.slots["checked"] = slots
    prog_ppr = (ppr.indptr, ppr.indices, ppr.weights)
    hits = hits_gap(res, got)
    if precision != stated:
        low = g.push(nodes, cfg["alpha"], cfg["eps"], np.float32)
        g.use_rows(low)
        ctl, _ = reference_scores(cfg, g, P, links, rows, precision)
        got = [c.cpu().numpy() for c in ctl]
        rows = [np.arange(len(r)) for r in rows]
        prog_ppr = rows_csr(low, g.n)
        hits = 0.0  # the reference's own formula in the program's place
    return {"score_gap": score_gap(got, refs, rows), "hits_gap": hits,
            "ppr_gap": cells.ppr_gap(exact, *prog_ppr)}


def checked_rows(links, tr: dict, seed: int) -> list:
    """The links of each split whose scores the check compares, drawn from
    the seed: ``positives_checked`` of a positive split,
    ``negatives_checked`` of a negative one."""
    rng = np.random.default_rng(seed)
    out = []
    for x, (_, positive) in zip(links, SPLITS):
        k = tr["positives_checked" if positive else "negatives_checked"]
        out.append(np.sort(rng.choice(len(x), min(k, len(x)),
                                      replace=False)))
    return out


@torch.no_grad()
def reference_scores(cfg, g, P, links, rows, precision: str):
    """The reference's eval-mode scores of the checked links of each
    split; and the mean valid context slots a link of the whole sweep, the
    checked links' mean of each split weighted by the split's size."""
    model = ref_model.Model(cfg, g, precision)
    dev, bsz = g.device, cfg["test_batch_size"]
    X = model.propagate(P)
    out, slots = [], 0.0
    for x, r in zip(links, rows):
        e = torch.as_tensor(x[r]).to(dev)
        model.slots = 0
        out.append(torch.cat([model.score(P, X, e[i:i + bsz, 0],
                                          e[i:i + bsz, 1])
                              for i in range(0, len(e), bsz)]))
        slots += float(model.slots) / max(len(r), 1) * len(x)
    return out, slots / sum(len(x) for x in links)


def score_gap(got: list, refs: list, rows: list) -> float:
    """The largest gap of any checked score."""
    if len(got) != len(refs):
        return float("inf")
    gap = 0.0
    for a, b, r in zip(got, refs, rows):
        b = b.double().cpu().numpy()
        a = np.asarray(a, np.float64)
        if a.ndim != 1 or len(a) <= (r.max() if len(r) else -1):
            return float("inf")
        a = a[r]
        if not np.isfinite(a).all():
            return float("inf")
        gap = max(gap, float(np.abs(a - b).max()) if len(a) else 0.0)
    return gap


def ogb_hits(pos, neg, k: int) -> float:
    """OGB's Hits@K of shared negatives: the share of the positives scored
    strictly above the K-th largest negative (1 under K negatives)."""
    pos, neg = np.asarray(pos, np.float64), np.asarray(neg, np.float64)
    if len(neg) < k:
        return 1.0
    kth = np.partition(neg, len(neg) - k)[len(neg) - k]
    return float((pos > kth).mean())


def hits_gap(res: dict, got: list) -> float:
    """The largest gap between the sweep's returned Hits (train, valid,
    test; the train positives against the valid negatives) and OGB's
    formula on the sweep's own scores."""
    if len(got) != len(SPLITS):
        return float("inf")
    pairs = ((got[0], got[3]), (got[1], got[3]), (got[2], got[4]))
    gap = 0.0
    for k in K_LIST:
        have = res.get(f"Hits@{k}")
        if have is None or len(have) != 3:
            return float("inf")
        for h, (pos, neg) in zip(have, pairs):
            gap = max(gap, abs(float(h) - ogb_hits(pos, neg, k)))
    return gap


def swapped(res: dict) -> dict:
    return {k: (t, s, v) for k, (t, v, s) in res.items()}


def calibrate(run: cells.Run, seeds: list, controls: int, emit) -> None:
    """Each seed's sound readings from one whole sweep; on the first
    ``controls`` seeds the control's and the swapped Hits' readings. One
    host build serves every seed."""
    cfg, dev = run.cfg, run.device
    stated = cfg["matmul_dtype"]
    graph, ppr, mask, host_s = program.build_graph(cfg, cfg["_data"], dev)
    g = cells.reference_graph(cfg, dev)
    emit("setup", None, {"host_build_s": host_s})
    for i, seed in enumerate(seeds):
        sd, links, ds, P = traffic(run, seed, graph, mask)
        with program.recording_scores() as scores:
            res = standard_sweep(cfg, P, ds)
        got = list(scores)
        run.spans = {}
        emit("sound", seed, dict(
            check(run, g, ppr, P, links, sd, got, res, stated),
            slots=run.slots["checked"], **run.spans))
        if i < controls:
            emit("control", seed, check(run, g, ppr, P, links, sd, got, res,
                                        cells.CONTROL[stated]))
            emit("hits", seed, {"hits_gap": hits_gap(swapped(res), got)})
        del ds, P, got, scores
        cells.free(dev)


def _fault(faults):
    """The sweep with the planted ``faults`` (see FAULTS)."""
    if not faults:
        return contextlib.nullcontext()
    from lpformer_tpu_torch.evalx import harness

    real, real_hits = harness.make_score_fn, harness.metrics.get_metric_score

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

    def hits(*a, **k):
        out = real_hits(*a, **k)
        return swapped(out) if "hits" in faults else out

    @contextlib.contextmanager
    def patched():
        harness.make_score_fn = make
        harness.metrics.get_metric_score = hits
        try:
            yield
        finally:
            harness.make_score_fn = real
            harness.metrics.get_metric_score = real_hits

    return patched()
