"""The parameter tree of LPFormer in its ``1-hop`` mode and the benchmark's
weights of it: ``reference/params.py``'s tree without the >1-hop class's
PPR encoder, its ``pairwise_lin`` taking dim + 3 (the three structure
counts of the mode). The weights are drawn as ``params.make_weights``
draws them, over this tree's leaves."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference import params
from reference.params import clone, leaves, nest  # noqa: F401


def spec(cfg: Dict, in_dim: int) -> List:
    """(path, shape, init) of every leaf, in ``params.spec``'s order."""
    d = cfg["dim"]
    pairwise = params._mlp("pairwise_lin", 2, d + 3, d + 3, d)
    out = []
    for leaf in params.spec(cfg, in_dim):
        name = leaf[0][0]
        if name == "pairwise_lin":
            out += pairwise
            pairwise = []
        elif name != "ppr_encoder_non1hop":
            out.append(leaf)
    return out


def make_weights(cfg: Dict, in_dim: int, seed: int, device) -> Dict:
    """The weights of ``seed``: one U(0, 1) draw on ``device`` split over
    the leaves and scaled to each leaf's bound (``params.make_weights``)."""
    sp = spec(cfg, in_dim)
    sizes = [math.prod(shape) for _, shape, _ in sp]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    pairs = []
    for (path, shape, init), part in zip(sp, torch.split(u, sizes)):
        if init == "ones":
            leaf = torch.ones(shape, device=device)
        elif init == "zeros":
            leaf = torch.zeros(shape, device=device)
        else:
            leaf = ((part * 2.0 - 1.0) * init).reshape(shape)
        pairs.append((path, leaf.contiguous()))
    return nest(pairs)
