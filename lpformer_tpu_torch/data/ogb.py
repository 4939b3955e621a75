"""OGB link-prediction dataset reader (counterpart of
``lpformer_tpu/data/ogb.py``).

Mirrors reference read_data_ogb (reference:
src/util/read_datasets.py:20-148): split loading (including citation2's
source/target layout), the collab >= 2007 year filter, the weighted
adjacency, ``--use-val-in-test``'s full-graph variant, HeaRT's negative
overrides and the DDI quarter-subsample of validation.

The ``ogb`` package is optional: without it the reader takes the
preprocessed npz that :func:`export_ogb_npz` writes (run once wherever
ogb is installed). Both paths give the same LinkPredDataset.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.data.dataset import LinkPredDataset, build_graph_bundle
from lpformer_tpu_torch.graph import ppr as ppr_mod
from lpformer_tpu_torch.graph.preprocess import coalesce_edges
from lpformer_tpu_torch.ops import masking


def _load_splits_ogb(data_name: str, data_dir: str):
    """Load via the ogb package (which downloads on first use)."""
    from ogb.linkproppred import PygLinkPropPredDataset  # type: ignore

    dataset = PygLinkPropPredDataset(name=data_name, root=data_dir)
    data = dataset[0]
    split_edge = dataset.get_edge_split()
    out = {"num_nodes": int(data.num_nodes)}
    ei = data.edge_index.numpy()
    ew = (
        data.edge_weight.view(-1).numpy().astype(np.float32)
        if getattr(data, "edge_weight", None) is not None
        else None
    )
    x = (
        data.x.numpy().astype(np.float32)
        if getattr(data, "x", None) is not None
        else None
    )

    if data_name != "ogbl-citation2":
        tr = split_edge["train"]["edge"].numpy()
        out["train_pos"] = tr
        out["valid_pos"] = split_edge["valid"]["edge"].numpy()
        out["valid_neg"] = split_edge["valid"]["edge_neg"].numpy()
        out["test_pos"] = split_edge["test"]["edge"].numpy()
        out["test_neg"] = split_edge["test"]["edge_neg"].numpy()
        if "collab" in data_name:
            out["train_year"] = split_edge["train"]["year"].numpy()
            out["train_weight"] = split_edge["train"]["weight"].numpy()
    else:
        s = split_edge["train"]["source_node"].numpy()
        t = split_edge["train"]["target_node"].numpy()
        out["train_pos"] = np.stack([s, t], axis=1)
        s = split_edge["valid"]["source_node"].numpy()
        t = split_edge["valid"]["target_node"].numpy()
        out["valid_pos"] = np.stack([s, t], axis=1)
        out["valid_neg"] = split_edge["valid"]["target_node_neg"].numpy()
        s = split_edge["test"]["source_node"].numpy()
        t = split_edge["test"]["target_node"].numpy()
        out["test_pos"] = np.stack([s, t], axis=1)
        out["test_neg"] = split_edge["test"]["target_node_neg"].numpy()
    out["edge_index"] = ei
    out["edge_weight"] = ew
    out["x"] = x
    return out


def export_ogb_npz(data_name: str, data_dir: str, out_path: str):
    """One-time export for environments without ogb."""
    raw = _load_splits_ogb(data_name, data_dir)
    np.savez_compressed(
        out_path, **{k: v for k, v in raw.items() if v is not None}
    )


def _load_splits_npz(path: str):
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files}
    out["num_nodes"] = int(out["num_nodes"])
    if "edge_weight" not in out:
        out["edge_weight"] = None
    if "x" not in out:
        out["x"] = None
    return out


def filter_by_year(raw, year: int = 2007):
    """collab >= 2007 filter (reference read_datasets.py:259-280): rebuilds
    edge_index as the undirected sum-reduced graph of the kept train
    edges."""
    sel = raw["train_year"] >= year
    tr = raw["train_pos"][sel]
    w = raw["train_weight"][sel].astype(np.float32)
    src = np.concatenate([tr[:, 0], tr[:, 1]])
    dst = np.concatenate([tr[:, 1], tr[:, 0]])
    ww = np.concatenate([w, w])
    s, d, wred = coalesce_edges(src, dst, ww, raw["num_nodes"], reduce="add")
    raw = dict(raw)
    raw["train_pos"] = tr
    raw["train_weight"] = w
    raw["edge_index"] = np.stack([s, d], axis=0)
    raw["edge_weight"] = wred
    return raw


def _torch_index(path: str) -> np.ndarray:
    """A HeaRT index file: a tensor saved with ``torch.save``."""
    with open(path, "rb") as f:
        return torch.load(f, weights_only=False).numpy()


def read_data_ogb(
    data_name: str,
    data_dir: str = "dataset",
    eps: float = 1e-4,
    alpha: float = 0.15,
    heart: bool = False,
    heart_dir: Optional[str] = None,
    use_val_in_test: bool = False,
    dim_for_featureless: int = 256,
    seed: int = 42,
    adj_cap: Optional[int] = None,
    ppr_cap: Optional[int] = None,
    cache_dir: Optional[str] = None,
    npz_path: Optional[str] = None,
    mask_input: bool = False,
    device=None,
) -> LinkPredDataset:
    """The dataset, its graph bundles on ``device`` (default CUDA). With
    ``use_val_in_test`` the eval graph is a second bundle over the train
    and valid edges, with its own PPR (cached with the ``_val`` suffix)."""
    dev = resolve_device(device)
    npz_default = os.path.join(data_dir, f"{data_name}.npz")
    if npz_path or os.path.exists(npz_default):
        raw = _load_splits_npz(npz_path or npz_default)
    else:
        try:
            raw = _load_splits_ogb(data_name, data_dir)
        except ImportError as e:
            raise ImportError(
                f"ogb not installed and no preprocessed npz found at "
                f"{npz_default}. Run export_ogb_npz() where ogb is "
                f"available."
            ) from e

    if "collab" in data_name and "train_year" in raw:
        raw = filter_by_year(raw)

    n = raw["num_nodes"]
    ei = raw["edge_index"]
    ew = raw["edge_weight"]
    if ew is None:
        ew = np.ones(ei.shape[1], dtype=np.float32)

    rng = np.random.default_rng(seed)
    train_pos = raw["train_pos"]
    valid_pos, valid_neg = raw["valid_pos"], raw["valid_neg"]
    test_pos, test_neg = raw["test_pos"], raw["test_neg"]

    # HeaRT overrides val/test POSITIVES for ogbl-ppa via saved index
    # files (reference read_datasets.py:59-67)
    if heart and "ppa" in data_name:
        hd0 = os.path.join(heart_dir or os.path.join(data_dir, "heart"),
                           data_name)
        valid_pos = valid_pos[_torch_index(
            os.path.join(hd0, "valid_samples_index.pt"))]
        test_pos = test_pos[_torch_index(
            os.path.join(hd0, "test_samples_index.pt"))]

    # featureless graphs (ddi/ppa): random features. The reference stores
    # a xavier Parameter in a dict so it never trains
    # (read_datasets.py:76-77): static random features are equivalent.
    if raw["x"] is not None:
        x = raw["x"].astype(np.float32)
    else:
        bound = float(np.sqrt(6.0 / (n + dim_for_featureless)))
        x = rng.uniform(-bound, bound, (n, dim_for_featureless)).astype(
            np.float32
        )

    idx = rng.permutation(len(train_pos))[: len(valid_pos)]
    train_pos_val = train_pos[idx]

    uniq, _ = masking.train_edge_info(train_pos[:, 0], train_pos[:, 1], n)

    ppr_csr = ppr_mod.get_ppr(
        data_name, ei[0], ei[1], n, alpha, eps, False, cache_dir=cache_dir
    )
    graph = build_graph_bundle(
        x, ei[0], ei[1], ew, n, ppr_csr,
        adj_cap=adj_cap, ppr_cap=ppr_cap,
        mask_uniq_keys=uniq, mask_input=mask_input, device=dev,
    )

    if use_val_in_test:
        # full graph = train edges + undirected valid edges, weight 1
        # (reference read_datasets.py:97-114)
        v = valid_pos
        vsrc = np.concatenate([v[:, 0], v[:, 1]])
        vdst = np.concatenate([v[:, 1], v[:, 0]])
        fsrc = np.concatenate([ei[0], vsrc])
        fdst = np.concatenate([ei[1], vdst])
        fw = np.concatenate([ew, np.ones(len(vsrc), np.float32)])
        ppr_test = ppr_mod.get_ppr(
            data_name, fsrc, fdst, n, alpha, eps, True, cache_dir=cache_dir
        )
        graph_test = build_graph_bundle(
            x, fsrc, fdst, fw, n, ppr_test,
            adj_cap=adj_cap, ppr_cap=ppr_cap,
            mask_uniq_keys=uniq, device=dev,
        )
    else:
        graph_test = graph

    metric = {
        "ogbl-collab": "Hits@50",
        "ogbl-ddi": "Hits@20",
        "ogbl-ppa": "Hits@100",
        "ogbl-citation2": "MRR",
    }.get(data_name, "MRR")
    if heart:
        metric = "MRR"
        hd = os.path.join(heart_dir or os.path.join(data_dir, "heart"),
                          data_name)
        valid_neg = np.load(os.path.join(hd, "heart_valid_samples.npy"))
        test_neg = np.load(os.path.join(hd, "heart_test_samples.npy"))
        if "ddi" in data_name:
            # quarter-subsample validation (reference :141-146)
            num_sample = len(valid_pos) // 4
            idx2 = rng.permutation(len(valid_pos))[:num_sample]
            valid_pos = valid_pos[idx2]
            valid_neg = valid_neg[idx2]
            train_pos_val = train_pos_val[idx2]

    return LinkPredDataset(
        name=data_name,
        num_nodes=n,
        graph=graph,
        graph_test=graph_test,
        train_pos=train_pos,
        train_pos_val=train_pos_val,
        valid_pos=valid_pos,
        valid_neg=valid_neg,
        test_pos=test_pos,
        test_neg=test_neg,
        metric=metric,
        heart=heart,
    )
