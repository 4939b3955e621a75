"""Training steps back to back in LPFormer's ``1-hop`` mode:
``kinds/train.py``'s traffic, set-up, window, check and calibration, with
the ``1-hop`` reference (``reference/onehop.py``) and its parameter tree
(``reference/params_onehop.py``) wherever ``train.py`` takes
``reference.model`` and ``reference.params``.

``train.py``'s functions are reused as they are: each is bound here to
globals of its own in which those two names are this module's references
(and ``TrainSetup`` this module's subclass, ``compare_train`` and ``check``
this module's). ``train.py``'s module is not touched, so both kinds run in
one process. A run reports its kind as ``train``, the name by which the
training readers (``metrics/train_links_per_s.py``,
``metrics/train_mfu.py``) know a training cell.

At lr 5e-3 from random weights Adam's first update moves every element by
about lr either way, and the loss jumps from 2 ln 2 to about 4.3, so the
later checked steps amplify round-off: sound runs' ``loss_gap``,
``grad_gap`` and ``delta_gap`` overlap a TF32 control's. Two numbers of
the first step are compared besides ``train.py``'s:

  * ``loss1_gap``: the first step's loss alone;
  * ``grad_err``: the first step's clipped gradient, by the median kept
    leaf's norm of the difference over the reference leaf's norm. Products
    rounded to TF32 move every leaf. In float32 a ReLU input that the two
    sides round to opposite sides of 0 moves the leaves behind it by about
    one link's share of their gradient, which is smaller.
"""
from __future__ import annotations

import math
import statistics
import types

import torch

from lpbench import cells
from reference import onehop, params_onehop

train = cells.kind_module("train")
FAULTS = train.FAULTS

_GLOBALS = dict(vars(train), ref_model=onehop, ref_params=params_onehop)


def compare_train(prog: dict, ref: dict) -> dict:
    """``train.compare_train``'s gaps, ``loss1_gap`` and ``grad_err``."""
    nums = train.compare_train(prog, ref)
    a, b = prog["losses"][0], ref["losses"][0]
    nums["loss1_gap"] = abs(a - b) / abs(b) if math.isfinite(a) else (
        float("inf"))
    gr = [train._norm(g) for g in ref["grad1"]]
    med = statistics.median(gr)
    errs = []
    for g, r, n in zip(prog["grad1"], ref["grad1"], gr):
        if n < 1e-3 * med:
            continue
        if g.numel() != r.numel():
            return dict(nums, grad_err=float("inf"))
        d = g.reshape(-1).to(r.device, torch.float64) - r.reshape(-1)
        errs.append(train._norm(d) / n)
    nums["grad_err"] = statistics.median(errs)
    return nums


def _bound(fn):
    """``fn`` of ``train.py`` reading this module's globals."""
    return types.FunctionType(fn.__code__, _GLOBALS, fn.__name__,
                              fn.__defaults__, fn.__closure__)


class OneHopSetup(train.TrainSetup):
    """``train.TrainSetup`` with the ``1-hop`` weights and reference."""

    __init__ = _bound(train.TrainSetup.__init__)
    reference = _bound(train.TrainSetup.reference)


_GLOBALS.update(TrainSetup=OneHopSetup, compare_train=compare_train)
check = _GLOBALS["check"] = _bound(train.check)
_run = _bound(train.run)
calibrate = _bound(train.calibrate)


def run(run: cells.Run, seed: int, seconds: float, trace: bool, faults,
        precision: str, t_start: float) -> dict:
    nums = _run(run, seed, seconds, trace, faults, precision, t_start)
    run.kind = "train"
    return nums
