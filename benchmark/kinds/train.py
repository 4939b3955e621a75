"""Training steps back to back, as ``train/trainer.py`` issues them, on
whole batches of a seeded permutation of the train edges with one uniform
negative a positive drawn by the step.

Set-up builds one training state from the seed and drives it through its
first ``checked_steps`` steps, through the window's own step and feed, on
different batches; the window continues the same state. The check, after
the window, follows those steps with the reference and compares

  * ``loss_gap``: each checked step's loss;
  * ``grad_gap``: the first step's clipped gradient, as the optimizer took
    it (its first moment over 1 - b1), by the worst leaf's gap of norms;
  * ``delta_gap``: each leaf's change over the checked steps, alike;
  * ``ppr_gap``: the reference's own PPR rows of the ``ppr_hubs_checked``
    highest-degree nodes and of ``ppr_rows_checked`` endpoints of the
    checked batches, drawn from the seed, against the program's.

The reference's context sets take the program's PPR matrix: a step's
three batches reach most nodes, more rows than a push in Python covers in
a run. Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of ``grad_gap`` and ``delta_gap``.
"""
from __future__ import annotations

import contextlib
import statistics
import sys
import time

import numpy as np
import torch

from lpbench import cells, program
from lpbench import data as data_mod
from lpbench.trace import Trace
from reference import model as ref_model
from reference import params as ref_params
from reference.graph import rows_csr

ADAM_B1 = 0.9

# "unchanged": the step returns the state it was given; "half": it steps
# on half of each batch; "loss": the returned loss is altered
FAULTS = ("unchanged", "half", "loss")


def _norm(x):
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gap(prog, ref, keep):
    """The worst leaf's gap between two norms, against the larger of the
    reference leaf's norm and the median kept leaf's; (gap, leaf index)."""
    med = statistics.median(ref[i] for i in keep)
    gaps = [(abs(prog[i] - ref[i]) / max(ref[i], med), i) for i in keep]
    return max(gaps)


def compare_train(prog: dict, ref: dict) -> dict:
    """The loss, gradient and change gaps of the checked steps."""
    gr = [_norm(g) for g in ref["grad1"]]
    gp = [_norm(g) for g in prog["grad1"]]
    med = statistics.median(gr)
    keep = [i for i, g in enumerate(gr) if g >= 1e-3 * med]
    dr = [_norm(d) for d in ref["delta"]]
    dp = [_norm(d) for d in prog["delta"]]
    loss = max(abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
               for a, b in zip(prog["losses"], ref["losses"]))
    g_gap, gi = leaf_gap(gp, gr, keep)
    d_gap, di = leaf_gap(dp, dr, keep)
    paths = ref["paths"]
    name = lambda i: "/".join(map(str, paths[i]))  # noqa: E731
    out = [name(i) for i in range(len(gr)) if i not in keep]
    print(f"[check] worst gradient leaf {name(gi)}, worst change leaf "
          f"{name(di)}; left out: {', '.join(out) or 'none'}", file=sys.stderr)
    return {"loss_gap": loss, "grad_gap": g_gap, "delta_gap": d_gap}


def _unflat(flat: torch.Tensor, like: list) -> list:
    return list(torch.split(flat, [x.numel() for x in like]))


class TrainSetup:
    """The training cell's state on one graph: the program's bundle and
    step, the seed's weights, batches and generator, and the checked
    steps' readings."""

    def __init__(self, run: cells.Run, graph, mask, seed: int, faults=()):
        cfg, dev = run.cfg, run.device
        data = cfg["_data"]
        self.seeds = seeds = data_mod.sub_seeds(seed)
        b = self.b = cfg["batch_size"]
        self.order = data_mod.train_order(len(data["edges"]), b,
                                          seeds["order"])
        self.edges = torch.as_tensor(data["edges"]).to(dev)
        self.order_dev = torch.as_tensor(self.order).to(dev)
        self.mult = torch.as_tensor(mask[1], dtype=torch.int32).to(dev)
        self.P = ref_params.make_weights(cfg, data["x"].shape[1],
                                         seeds["weights"], dev)
        self.P0 = ref_params.clone(self.P)
        step, opt = program.train_step(cfg, len(self.order))
        self.step = _train_fault(step, faults)
        self.state = program.train_state(self.P, opt)
        self.gen = torch.Generator(device=dev).manual_seed(seeds["gen"])
        self.w = torch.ones(b, device=dev)
        self.graph = graph

    def batch(self, j):
        links = self.edges[self.order_dev[j % len(self.order)]]
        return links[:, 0], links[:, 1]

    def __call__(self, j):
        self.state, loss = self.step(self.state, self.graph, self.mult, None,
                                     *self.batch(j), self.w, self.gen)
        return loss

    def checked(self, steps: int) -> dict:
        """The first ``steps`` steps, and what the check reads of them:
        each loss, the clipped gradient the optimizer took at the first
        (its first moment over 1 - b1) and each leaf's change."""
        losses = []
        for j in range(steps):
            losses.append(self(j))
            if j == 0:
                m1 = program.first_moment(self.state)
        now = [x for _, x in ref_params.leaves(self.P)]
        return {"losses": [float(x) for x in losses],
                "grad1": _unflat(m1 / (1.0 - ADAM_B1), now),
                "delta": [x.detach() - x0 for x, (_, x0) in
                          zip(now, ref_params.leaves(self.P0))]}

    def reference(self, cfg, g, steps: int, precision: str,
                  device) -> dict:
        model = ref_model.Model(cfg, g, precision)
        batches = [(*self.batch(j), self.w) for j in range(steps)]
        return ref_model.train_steps(model, ref_params.clone(self.P0, True),
                                     batches, cfg["lr"], self.seeds["gen"],
                                     device)


def run(run: cells.Run, seed: int, seconds: float, trace: bool, faults,
        precision: str, t_start: float) -> dict:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    graph, ppr, mask, run.host_build_s = program.build_graph(
        cfg, cfg["_data"], dev)
    ts = TrainSetup(run, graph, mask, seed, faults)
    checked = tr["checked_steps"]
    prog = ts.checked(checked)
    cells.sync(dev)
    run.setup_s = time.perf_counter() - t_start

    tracer = Trace() if trace else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx = (program.recording_pe_attention() if trace
           else contextlib.nullcontext([]))
    wl = []
    with ctx as calls:
        with (tracer.window(dev) if trace else contextlib.nullcontext()):
            t0 = time.perf_counter()
            j = checked
            while True:
                wl.append(ts(j))
                j += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            cells.sync(dev)
            run.window_s = time.perf_counter() - t0
    run.units = j - checked
    run.links = run.units * ts.b
    run.failed = int((~torch.isfinite(torch.stack(wl))).sum())
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if trace:
        run.trace = tracer.reduce()
        run.pe_calls = [(k, w1, kb, int(nv), bwd)
                        for k, w1, kb, nv, bwd in calls]
        pgen = torch.Generator(device=dev).manual_seed(ts.seeds["gen"] + 1)

        def prop():
            X = program.propagate(cfg, ts.P, graph, gen=pgen, train=True)
            X.backward(torch.ones_like(X))

        run.spans["propagate_train_s"] = cells.event_s(prop, dev)
    ts.state = ts.step = ts.graph = None
    del graph, wl, calls
    cells.free(dev)

    g = cells.reference_graph(cfg, dev)
    g.use_ppr(ppr.indptr, ppr.indices, ppr.weights)
    run.num_entries = g.a_hat._nnz()
    nums = check(run, g, ppr, ts, prog, precision)
    if trace:
        run.slots = train_slots(ref_model.Model(cfg, g, cfg["matmul_dtype"]),
                                ts, checked, dev)
    return nums


def check(run: cells.Run, g, ppr, ts: TrainSetup, prog: dict,
          precision: str, ref: dict = None) -> dict:
    """The compared numbers of the checked steps' readings ``prog``, on a
    reference graph ``g`` that holds the program's PPR matrix. A
    ``precision`` below the configuration's puts the reference at it in
    the program's place (the control): its steps at ``precision``, its PPR
    push in float32. ``ref``: the reference's readings, when known."""
    cfg, tr, dev = run.cfg, run.traffic, run.device
    stated, steps = cfg["matmul_dtype"], tr["checked_steps"]
    control = precision != stated
    if control:
        prog = ts.reference(cfg, g, steps, precision, dev)
    if ref is None:
        ref = cells.timed(run, "check_steps_s", ts.reference, cfg, g, steps,
                          stated, dev)
    nums = compare_train(prog, ref)
    nodes = checked_nodes(g, ts, tr)
    exact = cells.timed(run, "check_push_s", g.push, nodes, cfg["alpha"],
                        cfg["eps"])
    got = (rows_csr(g.push(nodes, cfg["alpha"], cfg["eps"], np.float32), g.n)
           if control else (ppr.indptr, ppr.indices, ppr.weights))
    nums["ppr_gap"] = cells.ppr_gap(exact, *got)
    return nums


def checked_nodes(g, ts: TrainSetup, tr: dict) -> np.ndarray:
    """The nodes whose PPR rows the check pushes itself: the highest-degree
    nodes, and endpoints of the checked batches drawn from the seed."""
    deg = np.diff(g.nbr_indptr)
    hubs = np.argsort(-deg, kind="stable")[:tr["ppr_hubs_checked"]]
    ends = np.unique(np.concatenate(
        [torch.stack(ts.batch(j)).cpu().numpy().reshape(-1)
         for j in range(tr["checked_steps"])]))
    rng = np.random.default_rng(ts.seeds["links"])
    pick = rng.choice(ends, min(tr["ppr_rows_checked"], len(ends)),
                      replace=False)
    return np.unique(np.concatenate([hubs, pick]))


def calibrate(run: cells.Run, seeds: list, controls: int, emit) -> None:
    """Each seed's sound readings; on the first ``controls`` seeds the
    control's and each planted fault's. One host build serves every
    seed."""
    cfg, dev = run.cfg, run.device
    stated, steps = cfg["matmul_dtype"], run.traffic["checked_steps"]
    graph, ppr, mask, host_s = program.build_graph(cfg, cfg["_data"], dev)
    g = cells.reference_graph(cfg, dev)
    g.use_ppr(ppr.indptr, ppr.indices, ppr.weights)
    emit("setup", None, {"host_build_s": host_s})
    for i, seed in enumerate(seeds):
        ts = TrainSetup(run, graph, mask, seed)
        prog = ts.checked(steps)
        ts.state = ts.step = None
        ref = ts.reference(cfg, g, steps, stated, dev)
        emit("sound", seed, check(run, g, ppr, ts, prog, stated, ref))
        if i < controls:
            emit("control", seed, check(run, g, ppr, ts, prog,
                                        cells.CONTROL[stated], ref))
            lossed = dict(prog, losses=[x * 1.01 for x in prog["losses"]])
            emit("loss", seed, check(run, g, ppr, ts, lossed, stated, ref))
            half = TrainSetup(run, graph, mask, seed, ("half",))
            hp = half.checked(steps)
            half.state = half.step = None
            emit("half", seed, check(run, g, ppr, half, hp, stated, ref))
            del half, hp
        del ts, prog, ref
        cells.free(dev)


@torch.no_grad()
def train_slots(model, ts: TrainSetup, j: int, dev) -> dict:
    """Mean valid context slots a positive and a negative link, on batch
    ``j`` (masked, subsampled) and a uniform negative batch."""
    sgen = torch.Generator(device=dev).manual_seed(ts.seeds["gen"] + 2)
    s, t = ts.batch(j)
    pos = model.context(s, t, model.batch_keys(s, t, ts.w), sgen)
    neg = torch.randint(0, model.g.n, (2, ts.b), generator=sgen, device=dev)
    negc = model.context(neg[0], neg[1], None, sgen)
    return {"pos": float(pos[4].sum()) / ts.b,
            "neg": float(negc[4].sum()) / ts.b}


def _train_fault(step, faults):
    """The step with a planted fault (the check's own tests): "unchanged"
    returns the state it was given, "half" steps on half of each batch,
    "loss" alters the returned loss."""
    if not faults:
        return step

    def faulty(state, graph, mult, binw, src, tgt, w, gen):
        if "half" in faults:
            h = src.shape[0] // 2
            src, tgt, w = src[:h], tgt[:h], w[:h]
        if "unchanged" in faults:
            keep = [x.detach().clone() for _, x in
                    ref_params.leaves(state.params)]
            _, loss = step(state, graph, mult, binw, src, tgt, w, gen)
            with torch.no_grad():
                for (_, x), k in zip(ref_params.leaves(state.params), keep):
                    x.copy_(k)
            new = state
        else:
            new, loss = step(state, graph, mult, binw, src, tgt, w, gen)
        if "loss" in faults:
            loss = loss * 1.01
        return new, loss

    return faulty


