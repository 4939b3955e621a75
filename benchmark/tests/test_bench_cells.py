"""Each cell of BENCHMARK.json runs end to end at a tiny size on the CPU
(the program's plain versions), with its own limits: a sound run is
correct, and the check says not correct for each planted fault its kind of
traffic can have and for the control one step below the configuration's
precision."""
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


def test_reference_attention_in_blocks(monkeypatch):
    """The reference's attention over blocks of links, each block's table
    cut to its own largest valid count and recomputed in the backward,
    gives the loss and gradients of one whole table."""
    import numpy as np
    import torch

    from lpbench import data as data_mod
    from reference import model as ref_model
    from reference import params as ref_params
    from reference.graph import RefGraph

    cfg, _ = SPEC.config("ppa-like")
    cfg.update(tiny()["config"])
    rng = np.random.default_rng(1)
    e = data_mod.random_edges(rng, 400, 4000)
    x = rng.standard_normal((400, 12)).astype(np.float32)
    g = RefGraph(e, x, 400, cfg["adj_cap"], cfg["ppr_cap"], "cpu")
    g.use_rows(g.push(range(400), cfg["alpha"], cfg["eps"]))
    links = torch.as_tensor(e[:256])
    w = torch.ones(256)

    def loss_and_grads(elems):
        monkeypatch.setattr(ref_model, "ATTEND_ELEMS", elems)
        P = ref_params.clone(ref_params.make_weights(cfg, 12, 5, "cpu"), True)
        gen = torch.Generator().manual_seed(9)
        loss = ref_model.Model(cfg, g, "float32").loss(
            P, links[:, 0], links[:, 1], w, gen)
        loss.backward()
        return loss.detach(), [x.grad for _, x in ref_params.leaves(P)]

    whole, gw = loss_and_grads(2 ** 40)
    blocks, gb = loss_and_grads(7 * cfg["budget_combined"] * cfg["dim"])
    torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=0)
    for a, b in zip(gb, gw):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
