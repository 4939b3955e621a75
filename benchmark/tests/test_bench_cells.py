"""Each kind of traffic runs end to end at a tiny size on the CPU (the
program's plain versions), in the cells of BENCHMARK.json and a test-only
training cell: a sound run is correct, and the check says not correct for
each planted fault the kind can have and for the control one step below
the configuration's precision."""
import math

import pytest

from lpbench import cells
from tiny import CELLS, SPEC, run_tiny, tiny


def _kind(cell):
    return SPEC.traffic(SPEC.cell(cell)["traffic"])["kind"]


def _control(cell):
    return cells.CONTROL[SPEC.config(SPEC.cell(cell)["config"])[0]
                         ["matmul_dtype"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(cell, trace):
    res = run_tiny(cell, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for m in res["metrics"].values():
        assert math.isfinite(m["value"])
    if trace:
        assert "host_build_s" in res["metrics"]
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in cells.kind_module(_kind(c)).FAULTS])
def test_planted_fault_is_not_correct(cell, fault):
    res = run_tiny(cell, faults=(fault,))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run_tiny(cell, precision=_control(cell))
    assert not res["correct"], res["checks"]
    sound = run_tiny(cell)
    assert all(res["checks"][k]["value"] > sound["checks"][k]["value"]
               for k in ("loss_gap", "score_gap", "ppr_gap")
               if k in res["checks"])


def test_eval_reference_pushes_its_own_rows():
    """The evaluation check's reference scores only links whose endpoints'
    PPR rows it pushed itself."""
    import numpy as np
    import torch

    from lpbench import data as data_mod
    from reference.graph import RefGraph
    from reference.model import Model

    cfg, _ = SPEC.config("citation2-like")
    cfg.update(tiny()["config"])
    e = data_mod.random_edges(np.random.default_rng(0), 400, 4000)
    x = np.zeros((400, 12), np.float32)
    g = RefGraph(e, x, 400, 16, 32, "cpu")
    g.use_rows(g.push([1, 2], cfg["alpha"], cfg["eps"]))
    m = Model(cfg, g, "float32")
    m.context(torch.tensor([1]), torch.tensor([2]))
    with pytest.raises(ValueError):
        m.context(torch.tensor([1]), torch.tensor([3]))
