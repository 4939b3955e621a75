"""The port's spans and counters (``utils/profiling.py``), on the CPU:
what they record with no profiler and under ``torch.profiler``, where
their trace events land against the profiler's own clock, and what the
evaluation sweeps, the graph build and the training step record."""
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
    valid = 0
    for edges, g in splits:
        t = torch.as_tensor(np.asarray(edges, np.int64))
        valid += int(extract_context(g.adj_rows, g.ppr_rows, t[:, 0],
                                     t[:, 1], CFG.context).valid.sum())
    links = sum(len(e) for e, _ in splits)
    assert links < batches * BATCH
    c = snap["counters"]
    assert c == {"context.valid_slots": valid,
                 "context.table_slots": links * CFG.context.total_budget}
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
