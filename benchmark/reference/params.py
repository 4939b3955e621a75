"""The parameter tree of LPFormer and the benchmark's weights.

The tree is LPFormer's published module layout, as nested dicts and lists
(the layout both the program's checkpoints and this reference read). The
weights are drawn by the benchmark from the seed, on the device, in one
uniform draw that is split and scaled per leaf.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Path = Tuple


def _mlp(name, layers, d_in, d_hid, d_out, norm=True) -> List:
    dims = [d_in] + [d_hid] * (layers - 1) + [d_out]
    out = []
    for j in range(layers):
        fi, fo = dims[j], dims[j + 1]
        out.append(((name, "layers", j, "w"), (fi, fo), 1.0 / math.sqrt(fi)))
        out.append(((name, "layers", j, "b"), (fo,), 1.0 / math.sqrt(fi)))
    if norm and layers > 1:
        out.append(((name, "norm", "g"), (d_hid,), "ones"))
        out.append(((name, "norm", "b"), (d_hid,), "zeros"))
    return out


def spec(cfg: Dict, in_dim: int) -> List:
    """(path, shape, init) of every leaf; init is a uniform bound, "ones"
    or "zeros". One attention layer of one head, the combined context
    table's three PPR encoders, four structure counts."""
    d, nl = cfg["dim"], cfg["gnn_layers"]
    out = []
    dims = [in_dim] + [d] * nl
    for i in range(nl):
        fi, fo = dims[i], dims[i + 1]
        out.append((("node_encoder", "convs", i, "w"), (fi, fo),
                    math.sqrt(6.0 / (fi + fo))))
        out.append((("node_encoder", "convs", i, "bias"), (fo,), "zeros"))
        out.append((("node_encoder", "lns", i, "g"), (fo,), "ones"))
        out.append((("node_encoder", "lns", i, "b"), (fo,), "zeros"))
    out.append((("gnn_norm", "g"), (d,), "ones"))
    out.append((("gnn_norm", "b"), (d,), "zeros"))
    out += _mlp("elementwise_lin", 2, d, d, d)
    for enc in ("ppr_encoder_cn", "ppr_encoder_onehop", "ppr_encoder_non1hop"):
        out += _mlp(enc, 2, 2, d, d)
    att = ("att_layers", 0)
    out.append((att + ("lin_l", "w"), (d, d), math.sqrt(6.0 / (2 * d))))
    out.append((att + ("lin_l", "b"), (d,), 1.0 / math.sqrt(d)))
    out.append((att + ("lin_r", "w"), (2 * d, d), math.sqrt(6.0 / (3 * d))))
    out.append((att + ("lin_r", "b"), (d,), 1.0 / math.sqrt(2 * d)))
    out.append((att + ("att",), (1, d), math.sqrt(6.0 / (1 + d))))
    out.append((att + ("bias",), (d,), "zeros"))
    out.append((att + ("post_norm", "g"), (d,), "ones"))
    out.append((att + ("post_norm", "b"), (d,), "zeros"))
    out += _mlp("pairwise_lin", 2, d + 4, d + 4, d)
    out += _mlp("score", cfg["pred_layers"], 2 * d, 2 * d, 1, norm=False)
    return out


def nest(pairs) -> Dict:
    """A nested dict/list tree from (path, leaf) pairs; an int key is a
    list index."""
    root: Dict = {}
    for path, leaf in pairs:
        node = root
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(nxt, int):
                node = node.setdefault(k, [])
            elif isinstance(k, int):
                while len(node) <= k:
                    node.append({})
                node = node[k]
            else:
                node = node.setdefault(k, {})
        last = path[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = leaf
    return root


def leaves(tree, path: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) pairs, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves(v, path + (i,))]
    return [(path, tree)]


def make_weights(cfg: Dict, in_dim: int, seed: int, device) -> Dict:
    """The weights of ``seed``: one U(0, 1) draw on ``device`` from a
    generator there, split over the leaves and scaled to each leaf's
    bound; norms' gains 1, biases of the convs and the attention 0."""
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


def clone(tree, requires_grad: bool = False):
    pairs = [(p, x.detach().clone().requires_grad_(requires_grad))
             for p, x in leaves(tree)]
    return nest(pairs)
