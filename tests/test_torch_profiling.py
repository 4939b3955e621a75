"""The port's spans and counters (``utils/profiling.py``), on the CPU:
what they record with no profiler and under ``torch.profiler``, where
their trace events land against the profiler's own clock, and what the
evaluation sweeps, the graph build and the training step record."""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lpformer_tpu_torch.data.dataset import build_graph_bundle
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.evalx import harness
from lpformer_tpu_torch.graph import ppr as ppr_mod
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.ops.context import extract_context
from lpformer_tpu_torch.train import optim, step
from lpformer_tpu_torch.utils import profiling

KW = dict(seed=2, num_nodes=90, num_train=320, num_eval=30, feat_dim=12,
          eps=1e-3)
CFG = LPFormerConfig(dim=16, gnn_layers=2, thresh_1hop=1e-3,
                     thresh_non1hop=1e-3, budget_combined=32)
BATCH = 64
SWEEP_CHILDREN = ("model.propagate", "eval.stage", "model.context",
                  "model.keys", "model.pe_attention", "model.score",
                  "eval.fetch", "eval.metric")
BUILD_PHASES = ("build.symmetrize", "build.csr", "build.cross_lookup",
                "build.padded_rows", "build.spmm_layout", "build.to_device")


@pytest.fixture(autouse=True)
def clean_tables():
    profiling.reset()
    yield
    profiling.reset()


class Spy(torch.Tensor):
    """A tensor that records every torch function applied to it."""
    calls = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        cls.calls.append(func)
        return super().__torch_function__(func, types, args, kwargs or {})


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _host_events(prof, names):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() in names]


def _dataset(citation=False):
    ds = synthetic_dataset(**KW, device="cpu")
    if citation:
        rng = np.random.default_rng(4)
        ds.valid_neg = rng.integers(0, KW["num_nodes"], (30, 7))
        ds.test_neg = rng.integers(0, KW["num_nodes"], (30, 7))
    params = lt.init_lpformer(torch.Generator().manual_seed(0), CFG,
                              KW["feat_dim"], device="cpu")
    profiling.reset()     # the dataset's own build spans
    return ds, params


def _citation2_splits(ds):
    """The [M, 2] edges a citation2 sweep scores, with their graphs, in
    the sweep's order."""
    def neg(pos, targets):
        k = targets.shape[1]
        return np.stack([np.repeat(pos[:, 0], k), targets.reshape(-1)], 1)

    return [(neg(ds.valid_pos, ds.valid_neg), ds.graph),
            (ds.valid_pos, ds.graph), (ds.test_pos, ds.graph_test),
            (neg(ds.test_pos, ds.test_neg), ds.graph_test)]


def _batches(edges):
    return math.ceil(len(edges) / BATCH)


def test_span_without_profiler_keeps_totals_only(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "_HostEvent",
                        lambda name: made.append(name))
    Spy.calls.clear()
    assert not profiling.active()
    for _ in range(3):
        with profiling.span("outer"):
            with profiling.span("inner"):
                time.sleep(0.001)
        profiling.count("device", torch.ones(5).as_subclass(Spy))
        profiling.count("host", 7)
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"outer", "outer/inner"}
    assert snap["spans"]["outer"][0] == snap["spans"]["outer/inner"][0] == 3
    assert snap["spans"]["outer"][1] >= snap["spans"]["outer/inner"][1]
    assert snap["spans"]["outer/inner"][1] >= 0.003
    assert snap["intervals"] == [] and snap["counters"] == {}
    assert made == [] and Spy.calls == []


def test_spans_land_in_the_profiler_trace_nested_and_stamped():
    Spy.calls.clear()
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
            with profiling.span("inner"):
                x = x + 1
            with profiling.span("inner"):
                x = x * 2
        profiling.count("device", torch.ones(5).as_subclass(Spy))
        profiling.count("device", torch.ones(3))
        profiling.count("host", 7)
    snap = profiling.snapshot()
    assert snap["counters"] == {"device": 8, "host": 7}
    assert Spy.calls
    assert snap["spans"]["outer"][0] == 1
    assert snap["spans"]["outer/inner"][0] == 2
    events = {n: sorted(_host_events(prof, {n}), key=lambda e: e.start_ns())
              for n in ("outer", "inner")}
    assert len(events["outer"]) == 1 and len(events["inner"]) == 2
    outer = events["outer"][0]
    for e in events["inner"]:
        assert outer.start_ns() <= e.start_ns() <= e.end_ns() <= outer.end_ns()
    # not a user annotation: none is mirrored on a device's timeline
    assert not any(e.is_user_annotation()
                   for e in events["outer"] + events["inner"])
    stamped = sorted(snap["intervals"], key=lambda iv: iv[1])
    assert [p for p, _, _ in stamped] == ["outer", "outer/inner",
                                          "outer/inner"]
    for (_, t0, t1), e in zip(stamped, events["outer"] + events["inner"]):
        assert abs(t0 - e.start_ns()) < 1_000_000
        assert abs(t1 - e.end_ns()) < 1_000_000


def test_reset_clears_everything():
    with _cpu_profile():
        with profiling.span("a"):
            profiling.count("c", 1)
    assert profiling.snapshot()["intervals"]
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "intervals": [],
                                    "counters": {}}


def test_real_rows_leave_out_the_padding_a_caller_names():
    x = torch.arange(6)
    assert profiling.real_rows(x) is x
    with profiling.padded(4):
        with profiling.padded(2):
            assert profiling.real_rows(x).tolist() == [0, 1]
        assert profiling.real_rows(x).tolist() == [0, 1, 2, 3]
    assert profiling.real_rows(x) is x


def test_citation2_sweep_records_every_span_and_counter():
    ds, params = _dataset(citation=True)
    splits = _citation2_splits(ds)
    with _cpu_profile() as prof:
        res = harness.test_citation2(params, CFG, ds, batch_size=BATCH)
    snap = profiling.snapshot()
    batches = sum(_batches(e) for e, _ in splits)
    props = 1 + (ds.graph_test is not ds.graph)
    want = {"eval.sweep": 1, "eval.sweep/eval.neg_edges": 2,
            "eval.sweep/model.propagate": props,
            "eval.sweep/eval.fetch": len(splits),
            "eval.sweep/eval.metric": 1}
    for name in ("eval.stage", "model.context", "model.keys",
                 "model.pe_attention", "model.score"):
        want["eval.sweep/" + name] = batches
    assert {p: c for p, (c, _) in snap["spans"].items()} == want
    assert sorted(p for p, _, _ in snap["intervals"]) == sorted(
        p for p, c in want.items() for _ in range(c))
    assert len(_host_events(prof, {"eval.sweep"})) == 1
    assert len(_host_events(prof, {"model.context"})) == batches

    # the padded (0, 0) rows of each split's last batch count nowhere
    valid = dropped = candidates = 0
    for edges, g in splits:
        t = torch.as_tensor(np.asarray(edges, np.int64))
        ctx = extract_context(g.adj_rows, g.ppr_rows, t[:, 0], t[:, 1],
                              CFG.context)
        valid += int(ctx.valid.sum())
        dropped += int(ctx.overflow.sum())
        candidates += len(edges) * CFG.context.candidate_columns(
            g.adj_rows.nbrs.shape[1], g.ppr_rows.nbrs.shape[1])
    links = sum(len(e) for e, _ in splits)
    assert links < batches * BATCH
    c = snap["counters"]
    assert c == {"context.valid_slots": valid,
                 "context.table_slots": links * CFG.context.total_budget,
                 "context.candidate_slots": candidates,
                 "context.dropped_slots": dropped}
    assert valid > 0

    # the same scores and MRRs with tracing off
    assert harness.test_citation2(params, CFG, ds, batch_size=BATCH) == res


def test_standard_sweep_records_every_span():
    ds, params = _dataset()
    splits = [ds.train_pos_val, ds.valid_pos, ds.test_pos, ds.valid_neg,
              ds.test_neg]
    with _cpu_profile():
        harness.test_standard(params, CFG, ds, batch_size=BATCH)
    snap = profiling.snapshot()
    batches = sum(_batches(e) for e in splits)
    counts = {p: c for p, (c, _) in snap["spans"].items()}
    assert counts["eval.sweep"] == 1
    assert counts["eval.sweep/eval.fetch"] == len(splits)
    assert counts["eval.sweep/eval.metric"] == 1
    assert counts["eval.sweep/model.propagate"] == 1 + (
        ds.graph_test is not ds.graph)
    for name in ("eval.stage", "model.context", "model.keys",
                 "model.pe_attention", "model.score"):
        assert counts["eval.sweep/" + name] == batches
    assert set(counts) == {"eval.sweep"} | {"eval.sweep/" + n
                                            for n in SWEEP_CHILDREN}
    assert snap["counters"]["context.table_slots"] == sum(
        len(e) for e in splits) * CFG.context.total_budget


@pytest.mark.parametrize("traced", [False, True])
def test_scores_are_bit_identical_traced_and_not(traced):
    ds, params = _dataset()
    X = lt.propagate(params, CFG, ds.graph)
    fn = harness.make_score_fn(CFG)
    plain = harness.score_edges(fn, params, ds.graph, X, ds.valid_neg, 16)
    if traced:
        with _cpu_profile():
            got = harness.score_edges(fn, params, ds.graph, X, ds.valid_neg,
                                      16)
    else:
        with profiling.span("outer"):
            got = harness.score_edges(fn, params, ds.graph, X, ds.valid_neg,
                                      16)
    assert got.dtype == plain.dtype and np.array_equal(got, plain)


@pytest.mark.parametrize("traced", [False, True])
def test_build_records_its_phases(traced):
    ds = synthetic_dataset(**KW, device="cpu")
    e = ds.train_pos
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    profiling.reset()
    with (_cpu_profile() if traced else profiling.span("host")):
        ppr = ppr_mod.ppr_push_csr(src, dst, KW["num_nodes"], eps=1e-3,
                                   method="numpy")
        build_graph_bundle(ds.graph.x.numpy(), e[:, 0], e[:, 1], None,
                           KW["num_nodes"], ppr, adj_cap=16, ppr_cap=32,
                           device="cpu")
    spans = profiling.snapshot()["spans"]
    top = "" if traced else "host/"
    want = {top + "build.ppr_push", top + "build.bundle"} | {
        f"{top}build.bundle/{p}" for p in BUILD_PHASES}
    assert set(spans) - {"host"} == want
    assert all(c == 1 for c, _ in spans.values())
    bundle = spans[top + "build.bundle"][1]
    assert sum(spans[f"{top}build.bundle/{p}"][1]
               for p in BUILD_PHASES) <= bundle
    assert bool(profiling.snapshot()["intervals"]) == traced


def test_train_step_records_its_phases_once_a_step():
    ds, params = _dataset()
    opt = optim.make_optimizer(1e-3, 0.0, 1.0, 4, clip_norm=1.0)
    fn = step.make_train_step(CFG, opt)
    for p in optim.tree_leaves(params):
        p.requires_grad_(True)
    state = step.TrainState(params, opt.init(params), 0)
    gen = torch.Generator().manual_seed(1)
    src = torch.as_tensor(ds.train_pos[:32, 0])
    tgt = torch.as_tensor(ds.train_pos[:32, 1])
    w = torch.ones(32)
    with _cpu_profile():
        for _ in range(2):
            state, _ = fn(state, ds.graph, ds.mask_mult_device, None, src,
                          tgt, w, gen)
    counts = {p: c for p, (c, _) in profiling.snapshot()["spans"].items()}
    for name in ("train.propagate", "train.forward", "train.backward",
                 "train.optimizer"):
        assert counts[name] == 2, counts
    assert counts["train.propagate/model.propagate"] == 2
    assert counts["train.forward/model.context"] == 4


def _train_steps(cfg, steps=2, traced=True):
    """``steps`` tiny training steps of ``cfg``, under a CPU profiler when
    ``traced``."""
    ds = synthetic_dataset(**KW, device="cpu")
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              KW["feat_dim"], device="cpu")
    profiling.reset()
    opt = optim.make_optimizer(1e-3, 0.0, 1.0, 4, clip_norm=1.0)
    fn = step.make_train_step(cfg, opt)
    for p in optim.tree_leaves(params):
        p.requires_grad_(True)
    state = step.TrainState(params, opt.init(params), 0)
    gen = torch.Generator().manual_seed(1)
    src = torch.as_tensor(ds.train_pos[:32, 0])
    tgt = torch.as_tensor(ds.train_pos[:32, 1])
    with (_cpu_profile() if traced else profiling.span("host")):
        for _ in range(steps):
            state, _ = fn(state, ds.graph, ds.mask_mult_device, None, src,
                          tgt, torch.ones(32), gen)
    return profiling.snapshot()


@pytest.mark.parametrize("budget", [32, None])
@pytest.mark.parametrize("remat", [False, True])
def test_pe_attention_backward_span_nests_under_train_backward(budget,
                                                               remat):
    """Both tables' fused op: one ``model.pe_attention.bwd`` a half a step,
    inside ``train.backward`` (under remat beside the recomputed
    forward)."""
    cfg = dataclasses.replace(CFG, budget_combined=budget,
                              remat_pairwise=remat)
    snap = _train_steps(cfg)
    counts = {p: c for p, (c, _) in snap["spans"].items()}
    assert counts["train.backward/model.pe_attention.bwd"] == 4, counts
    assert not [p for p in counts if p.endswith("model.pe_attention.bwd")
                and p != "train.backward/model.pe_attention.bwd"]
    assert counts.get("train.backward/model.pe_attention", 0) == (
        4 if remat else 0)
    paths = [p for p, _, _ in snap["intervals"]]
    assert paths.count("train.backward/model.pe_attention.bwd") == 4


def test_context_counters_count_candidates_and_dropped_slots():
    """``context.candidate_slots`` counts each real link's candidate
    columns, ``context.dropped_slots`` the valid candidates its budget
    dropped: none under a budget of every candidate, some under one forced
    to overflow (the classic table's too)."""
    ds, params = _dataset()
    edges = ds.valid_neg
    g = ds.graph
    t = torch.as_tensor(np.asarray(edges, np.int64))
    cols = 3 * g.adj_rows.nbrs.shape[1] + g.ppr_rows.nbrs.shape[1]
    for cfg, overflows in ((dataclasses.replace(CFG, budget_combined=cols),
                            False),
                           (dataclasses.replace(CFG, budget_combined=2),
                            True),
                           (dataclasses.replace(
                               CFG, budget_combined=None, budget_cn=1,
                               budget_onehop=2, budget_non1hop=1), True)):
        params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                                  KW["feat_dim"], device="cpu")
        profiling.reset()
        X = lt.propagate(params, cfg, g)
        with _cpu_profile():
            harness.score_edges(harness.make_score_fn(cfg), params, g, X,
                                edges, BATCH)
        c = profiling.snapshot()["counters"]
        ctx = extract_context(g.adj_rows, g.ppr_rows, t[:, 0], t[:, 1],
                              cfg.context)
        dropped = int(ctx.overflow.sum())
        assert c["context.candidate_slots"] == len(edges) * cols
        assert c["context.dropped_slots"] == dropped
        assert (dropped > 0) == overflows
        assert c["context.valid_slots"] + dropped <= len(edges) * cols


def test_backward_span_and_context_counters_launch_nothing_untraced(
        monkeypatch):
    """With no profiler the backward span makes no trace event and the
    context counters are never reached: no counter call, no counter."""
    made, counted = [], []
    monkeypatch.setattr(profiling, "_HostEvent",
                        lambda name: made.append(name))
    real = profiling.count
    monkeypatch.setattr(profiling, "count",
                        lambda *a: (counted.append(a[0]), real(*a)))
    snap = _train_steps(CFG, steps=1, traced=False)
    assert snap["spans"]["host/train.backward/model.pe_attention.bwd"][0] \
        == 2
    assert made == [] and counted == [] and snap["counters"] == {}
