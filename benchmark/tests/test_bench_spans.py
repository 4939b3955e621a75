"""lpbench/spans.py, which reads the program's own spans and counters: the
attribution of device kernels to spans and of idle time inside them on
synthetic events, the metrics it feeds in traced tiny runs on the CPU (the
host's operators standing in for the device's in the training cell), the
training step's spans, and None against a program that records none."""
import types

import pytest

from lpbench import spans
from lpbench.spec import Spec
from tiny import TINY, run_tiny

NEW = ("node_encoder_ms.eval", "context_ms.eval", "key_gather_ms.eval",
       "harness_stall_ms.eval", "context_fill.eval", "ppr_push_s",
       "bundle_build_s", "context_ms.train", "backward_ms.train",
       "optimizer_ms.train")
TRAIN_SPANS = ("context_ms.train", "backward_ms.train", "optimizer_ms.train")

# spans a [0, 100] with a/b [10, 50] nested, c [200, 300], and one of an
# earlier window; launches (correlation id -> ns) and device operations
INTERVALS = [("old", -1000, -900), ("a", 0, 100), ("a/b", 10, 50),
             ("c", 200, 300)]
LAUNCHES = {1: 5, 2: 20, 3: 60, 4: 150, 5: 250}
DEVICE = [(1, 100, 110), (2, 110, 130), (3, 140, 150), (4, 160, 170),
          (5, 260, 300), (6, 400, 410)]
WINDOW = (-10, 420)


@pytest.fixture
def program():
    from lpformer_tpu_torch.utils import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


def test_innermost_span_is_charged():
    a = spans.Attribution(INTERVALS, LAUNCHES, DEVICE, WINDOW)
    # 4 is launched between spans, 6 has no launch: charged to none
    assert a.charged == {"a": 20, "a/b": 20, "c": 40, "": 20}
    assert a.device_s("a") == pytest.approx(40e-9)
    assert a.device_s("b") == pytest.approx(20e-9)
    assert a.device_s("old") == 0
    assert [p for p, _, _ in a.intervals] == ["a", "a/b", "c"]


def test_idle_inside_spans():
    a = spans.Attribution(INTERVALS, LAUNCHES, DEVICE, WINDOW)
    assert a.idle_s({"c"}) == pytest.approx(60e-9)      # busy 260-300
    assert a.idle_s({"a"}) == pytest.approx(100e-9)     # busy from 100 on
    # the union of nested spans counts once
    assert a.idle_s({"a", "b"}) == pytest.approx(100e-9)
    assert a.idle_s({"a", "c"}) == pytest.approx(160e-9)
    assert a.idle_s({"none"}) == 0.0
    # the whole window: busy is the union of the device's operations
    w = spans.Attribution(INTERVALS + [("w", -10, 420)], LAUNCHES, DEVICE,
                          WINDOW)
    assert w.idle_s({"w"}) == pytest.approx(330e-9)
    # a span wholly inside a busy stretch: no idle time
    b = spans.Attribution([("d", 102, 108)], {}, DEVICE, WINDOW)
    assert b.idle_s({"d"}) == 0.0


def test_new_metrics_are_per_layer_entries():
    spec = Spec()
    names = [m["name"] for m in spec.bench["per_layer"]]
    assert [n for n in names if n in NEW] == list(NEW)
    for m in spec.bench["per_layer"]:
        if m["name"] in NEW:
            assert m["source"] == "program_span"
            assert ("workloads" in m) == m["name"].endswith(
                (".eval", ".train"))
    for cell, suffix in (("citation2-like.eval", ".train"),
                         ("ppa-like.train", ".eval")):
        assert {n for n in NEW if not n.endswith(suffix)} <= {
            m["name"] for m in spec.metrics(cell, True)}


def test_traced_eval_run_reads_the_host_metrics(program):
    res = run_tiny("citation2-like.eval", trace=1)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert 0 < got["context_fill.eval"]["value"] <= 100
    build = got["ppr_push_s"]["value"] + got["bundle_build_s"]["value"]
    assert 0 < build <= got["host_build_s"]["value"]
    # the device's readings need a card
    for name in ("node_encoder_ms.eval", "context_ms.eval",
                 "key_gather_ms.eval", "harness_stall_ms.eval"):
        assert name not in got
    # the counters and intervals are the window's sweeps'
    tr = TINY["traffic"]
    per_sweep = 2 * tr["positives_per_split"] * (
        1 + tr["negatives_per_positive"])
    snap = program.snapshot()
    assert snap["counters"]["context.table_slots"] == (
        res["attempted"] * per_sweep * TINY["config"]["budget_combined"])
    paths = [p for p, _, _ in snap["intervals"]]
    assert paths.count("eval.sweep") == res["attempted"] > 0


def _host_ops_as_device(prof):
    """``spans._kineto`` with the profiler's host operators (``aten::``)
    taken for the device's operations, each launched at its own start: on
    the CPU the profiler records no operation of a device."""
    launches, device = {}, []
    lo, hi = float("inf"), float("-inf")
    for i, e in enumerate(prof.profiler.kineto_results.events()):
        lo, hi = min(lo, e.start_ns()), max(hi, e.end_ns())
        if e.name().startswith("aten::"):
            launches[-1 - i] = e.start_ns()
            device.append((-1 - i, e.start_ns(), e.end_ns()))
    return launches, device, (lo, hi)


def test_traced_train_run_reads_the_span_and_host_metrics(program,
                                                          monkeypatch):
    monkeypatch.setattr(spans, "_kineto", _host_ops_as_device)
    res = run_tiny("ppa-like.train", trace=1)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in TRAIN_SPANS:
        assert got[name]["value"] > 0, name
    build = got["ppr_push_s"]["value"] + got["bundle_build_s"]["value"]
    assert 0 < build <= got["host_build_s"]["value"]


def test_untraced_run_keeps_its_metric_names(program):
    res = run_tiny("citation2-like.eval", trace=0)
    assert not set(NEW) & set(res["metrics"])
    assert program.snapshot()["counters"] == {}


def test_train_step_spans_once_a_step(program):
    res = run_tiny("ppa-like.train", trace=1)
    assert res["correct"], res["checks"]
    paths = [p for p, _, _ in program.snapshot()["intervals"]]
    for name in ("train.propagate", "train.forward", "train.backward",
                 "train.optimizer"):
        assert paths.count(name) == res["attempted"] > 0


def test_readers_are_silent_without_program_spans(monkeypatch):
    from lpformer_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    trace = types.SimpleNamespace(prof=object())
    run = types.SimpleNamespace(trace=trace, units=2)
    assert spans.attribution(run) is None
    for name in NEW:
        assert Spec.reader(name)(run) is None
