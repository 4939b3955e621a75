"""The graphs and the traffic, generated from seeds.

A configuration's graph (train edges and node features) comes from its
fixed ``data_seed`` and is cached under ``benchmark/.cache/``, keyed by the
configuration file's bytes: the only thing the benchmark caches. The
traffic (batch order, evaluation links) comes from the run's ``--seed``.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".cache")


def random_edges(rng: np.random.Generator, num_nodes: int, num_edges: int,
                 power: float = 0.8) -> np.ndarray:
    """[M, 2] directed edges without self loops (duplicates allowed, like
    the OGB splits), endpoints drawn with weight rank^-power."""
    w = (np.arange(1, num_nodes + 1) ** -power).astype(np.float64)
    p = w / w.sum()
    src = rng.choice(num_nodes, size=num_edges * 2, p=p)
    dst = rng.choice(num_nodes, size=num_edges * 2, p=p)
    ok = src != dst
    e = np.stack([src[ok], dst[ok]], axis=1)[:num_edges]
    while len(e) < num_edges:  # top up if too many self loops
        extra = random_edges(rng, num_nodes, num_edges - len(e), power)
        e = np.concatenate([e, extra], axis=0)
    return e.astype(np.int64)


def graph_data(cfg: dict, cfg_bytes: bytes, cache: str = CACHE) -> dict:
    """{"edges": [M, 2] int64, "x": [N, F] float32} of the configuration,
    from the cache when its key matches."""
    key = hashlib.sha1(cfg_bytes).hexdigest()[:16]
    path = os.path.join(cache, f"{cfg['name']}-{key}.npz")
    if os.path.isfile(path):
        with np.load(path) as z:
            return {"edges": z["edges"].astype(np.int64), "x": z["x"]}
    rng = np.random.default_rng(cfg["data_seed"])
    n = cfg["num_nodes"]
    edges = random_edges(rng, n, cfg["num_train_edges"], cfg["power"])
    x = rng.standard_normal((n, cfg["feat_dim"])).astype(np.float32)
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, edges=edges.astype(np.int32), x=x)
    os.replace(tmp, path)
    return {"edges": edges, "x": x}


def sub_seeds(seed: int) -> dict:
    """Independent seeds of the run's parts, from ``--seed``."""
    w, order, gen, links = np.random.SeedSequence(
        abs(int(seed))).generate_state(4, dtype=np.uint32)
    return {"weights": int(w), "order": int(order), "gen": int(gen),
            "links": int(links)}


def train_order(num_edges: int, batch: int, seed: int) -> np.ndarray:
    """The batches' edge indices [S, B]: a seeded permutation cut into
    whole batches."""
    perm = np.random.default_rng(seed).permutation(num_edges)
    steps = num_edges // batch
    return perm[:steps * batch].reshape(steps, batch)


def citation2_links(num_nodes: int, positives: int, negatives: int,
                    power: float, seed: int, splits: int = 2):
    """Per split: the positives [P, 2] (power-law endpoints, as the graph's
    edges) and each positive's ``negatives`` uniform target ids [P, K],
    ogbl-citation2's evaluation draw."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(splits):
        pos = random_edges(rng, num_nodes, positives, power)
        out.append((pos, rng.integers(0, num_nodes, (positives, negatives))))
    return out
