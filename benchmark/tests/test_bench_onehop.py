"""What the two kinds of traffic added beside ``train`` and
``citation2_sweep`` hold that the cell-wide tests do not: ``train_onehop``
reuses ``kinds/train.py`` without touching its module and adds two
numbers of the first step to its check, the ``1-hop`` reference's weights
are the program's tree, ``hits_sweep``'s Hits is OGB's formula and its
traced slots the window's counter, and on the card the ``ddi-like`` cell
at its published width (dim 256 float32) is correct and its control is
not."""
import numpy as np
import pytest
import torch

from lpbench import cells
from tiny import SPEC, run_tiny


def test_onehop_kind_leaves_train_module_untouched():
    from reference import model as ref_model
    from reference import params as ref_params
    train = cells.kind_module("train")
    onehop = cells.kind_module("train_onehop")
    assert train.ref_model is ref_model and train.ref_params is ref_params
    assert onehop.OneHopSetup.__init__.__globals__["ref_model"] is not (
        ref_model)
    assert train.TrainSetup.__init__.__globals__ is vars(train)
    assert onehop.FAULTS == train.FAULTS


def test_onehop_first_step_numbers():
    """``loss1_gap`` reads the first step's loss alone; ``grad_err`` is
    the median kept leaf's relative error, so one leaf's swing moves
    ``grad_gap`` and not it, and an error on every leaf moves it."""
    onehop = cells.kind_module("train_onehop")
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(s, generator=g) for s in (5, 7, 9, 11, 13)]
    ref = {"losses": [1.0, 2.0, 3.0], "grad1": grads,
           "delta": [x.clone() for x in grads], "paths": [(i,) for i in
                                                          range(5)]}
    flat = [x.reshape(-1).clone() for x in grads]
    same = onehop.compare_train(dict(ref, grad1=flat), ref)
    assert same["loss1_gap"] == same["grad_err"] == same["grad_gap"] == 0
    late = onehop.compare_train(dict(ref, losses=[1.0, 2.0, 3.3]), ref)
    assert late["loss1_gap"] == 0 and late["loss_gap"] > 0.09
    one = [x.clone() for x in flat]
    one[2] *= 3.0
    swing = onehop.compare_train(dict(ref, grad1=one), ref)
    assert swing["grad_gap"] > 1.0 and swing["grad_err"] == 0
    noise = [x + 1e-3 * x.norm() / x.numel() ** 0.5 * torch.randn(
        x.shape, generator=g) for x in flat]
    err = onehop.compare_train(dict(ref, grad1=noise), ref)["grad_err"]
    assert 3e-4 < err < 3e-3
    short = onehop.compare_train(dict(ref, grad1=flat[:4] + [flat[4][:3]]),
                                 ref)
    assert short["grad_err"] == float("inf")


def test_onehop_weights_are_the_program_tree():
    """``params_onehop``'s tree has the leaves and shapes of the program's
    own ``init_lpformer`` in the ``1-hop`` mode."""
    from lpbench import program
    from reference import params_onehop
    from lpformer_tpu_torch.models import link_transformer as lt
    cfg, _ = SPEC.config("ddi-like")
    cfg.update(dim=16)
    mine = params_onehop.make_weights(cfg, 12, 3, "cpu")
    theirs = lt.init_lpformer(torch.Generator().manual_seed(0),
                              program.model_config(cfg), 12, "cpu")
    assert program.model_config(cfg).mask_mode == "1-hop"
    got = [(p, tuple(x.shape)) for p, x in params_onehop.leaves(mine)]
    want = [(p, tuple(x.shape)) for p, x in params_onehop.leaves(theirs)]
    assert got == want


def test_hits_is_ogb_formula():
    hits = cells.kind_module("hits_sweep")
    rng = np.random.default_rng(0)
    pos, neg = rng.random(300), rng.random(1000)
    for k in (20, 50, 100):
        kth = np.sort(neg)[::-1][k - 1]
        assert hits.ogb_hits(pos, neg, k) == np.mean(pos > kth)
    assert hits.ogb_hits(pos, neg[:10], 20) == 1.0
    # the sweep's order: train, valid, test positives, valid, test negatives
    got = [pos[:100], pos[100:200], pos[200:], neg[:500], neg[500:]]
    res = {f"Hits@{k}": (hits.ogb_hits(got[0], got[3], k),
                         hits.ogb_hits(got[1], got[3], k),
                         hits.ogb_hits(got[2], got[4], k))
           for k in hits.K_LIST}
    assert hits.hits_gap(res, got) == 0.0
    assert hits.hits_gap(hits.swapped(res), got) > 0.0
    assert hits.hits_gap(res, got[:4]) == float("inf")


def test_hits_sweep_slots_are_the_window_counter(monkeypatch):
    """A traced ``ppa-like.eval`` run's valid slots a link, which
    ``eval_mfu`` counts the work by, are the program's
    ``context.valid_slots`` over the window's links, not the checked
    links' sample."""
    from lpformer_tpu_torch.utils import profiling
    seen, real = {}, cells.run_cell

    def keep(run, *a):
        seen["run"] = run
        return real(run, *a)

    monkeypatch.setattr(cells, "run_cell", keep)
    before = profiling.snapshot()["counters"].get("context.valid_slots", 0)
    res = run_tiny("ppa-like.eval", trace=1)
    assert res["correct"], res["checks"]
    run = seen["run"]
    valid = profiling.snapshot()["counters"]["context.valid_slots"] - before
    tr = run.traffic
    per_sweep = tr["positives_per_split"] * (3 + 2 * tr[
        "negatives_per_positive"])
    assert run.links == run.units * per_sweep > 0
    assert run.slots["eval"] == valid / run.links > 0
    assert "checked" in run.slots


@pytest.mark.cuda
def test_ddi_cell_at_published_width_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import run as bench_run
    from tiny import tiny

    def go(**kw):
        return bench_run.main(
            ["--workload", "ddi-like.train", "--seed", "3000000029",
             "--seconds", "0.5", "--trace", "1"], device="cuda", spec=SPEC,
            overrides=tiny(dim=256), **kw)

    res = go()
    assert res["correct"], res["checks"]
    assert res["metrics"]["pe_attention_bwd_ms.train"]["value"] > 0
    assert res["metrics"]["context_dropped.train"]["value"] >= 0
    ctl = go(precision=cells.CONTROL["float32"])
    assert not ctl["correct"], ctl["checks"]
