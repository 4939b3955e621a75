"""Versioned, pickle-free checkpoints (counterpart of
``lpformer_tpu/utils/checkpoint.py``), in the JAX package's file format,
so a file written by either package loads in the other.

Format ``lpformer-tpu-ckpt`` version 1: one ``.npz`` zip holding one array
per leaf of the state tree, named ``leaf_00000``, ``leaf_00001``, ... in
the tree's flattening order (dict keys sorted, sequences in order), and a
``__manifest__`` uint8 array of JSON::

  {"format": "lpformer-tpu-ckpt", "version": 1,
   "paths": [{"name": "leaf_00000", "path": [["d", "epoch"]]}, ...]}

where each path component is ``["d", key]`` for a dict key or ``["s", i]``
for a sequence index. A leaf whose dtype npz cannot store (bfloat16) is
stored as float32 with ``"dtype": "bfloat16"`` in its entry and cast back
on load. The training state is ``{params, opt_state, step, epoch, seed}``:
the parameters' nested dicts and lists, the fused optimizer's
``{count, m, v, score_mask}``, the step as a 0-d int32, and the epoch
and seed as integers (int64 arrays in the file).

Writes are atomic (a temporary file, then ``os.replace``). Loads never
unpickle (``allow_pickle=False``), and refuse any file that is not such a
zip, a pickle file among them.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FORMAT_NAME = "lpformer-tpu-ckpt"
FORMAT_VERSION = 1

_PICKLE_MAGIC = b"\x80"  # pickle protocol-2+ opcode PROTO
# dtypes npz cannot hold, stored upcast to float32 under their JAX names
_UPCAST = {torch.bfloat16: "bfloat16"}
_BY_NAME = {v: k for k, v in _UPCAST.items()}


def _flatten(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path components, leaf) pairs in the JAX package's flattening
    order: dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (("d", k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (("s", i),))
        return out
    return [(path, tree)]


def _canon(comps) -> str:
    return "/".join(f"{t}:{v}" for t, v in comps)


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a numpy array, and the name of its true dtype where the
    array is a float32 upcast."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _UPCAST:
            return t.float().numpy(), _UPCAST[t.dtype]
        return t.numpy(), None
    return np.asarray(leaf), None


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` (nested dicts and lists of tensors, numpy arrays or
    numbers) to ``path``, atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    entries = []
    for i, (comps, leaf) in enumerate(_flatten(state)):
        name = f"leaf_{i:05d}"
        arr, true_dtype = _to_numpy(leaf)
        entry = {"name": name, "path": [list(c) for c in comps]}
        if true_dtype is not None:
            entry["dtype"] = true_dtype
        arrays[name] = arr
        entries.append(entry)
    manifest = {"format": FORMAT_NAME, "version": FORMAT_VERSION,
                "paths": entries}
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8).copy()
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _reconstruct(entries):
    """A nested structure from (path components, leaf) pairs: dict keys
    become dict entries, sequence indices lists."""
    if len(entries) == 1 and not entries[0][0]:
        return entries[0][1]
    root: Dict = {}
    for comps, leaf in entries:
        cur = root
        for ci, key in enumerate(comps):
            if ci == len(comps) - 1:
                cur[key] = leaf
            else:
                cur = cur.setdefault(key, {})

    def finalize(node):
        if not isinstance(node, dict):
            return node
        if node and all(t == "s" for t, _ in node):
            idxs = sorted(v for _, v in node)
            if idxs != list(range(len(idxs))):
                raise ValueError(f"non-contiguous sequence indices in "
                                 f"checkpoint: {idxs}")
            return [finalize(node[("s", i)]) for i in idxs]
        return {v: finalize(child) for (_, v), child in node.items()}

    return finalize(root)


def _unflatten_like(target, leaves):
    """``target``'s structure with its leaves replaced in flattening
    order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(target)


def load_checkpoint(path: str, target: Optional[Any] = None):
    """Load a checkpoint of either package; None if ``path`` does not
    exist. Every leaf comes back as a tensor (on the CPU, or on the
    device of the ``target`` leaf it replaces). With ``target`` the leaves
    are restored into its structure, matched by path and validated both
    ways; without it, into nested dicts and lists."""
    if not os.path.exists(path):
        return None
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            head = f.read(1)
        if head == _PICKLE_MAGIC:
            raise ValueError(f"{path}: a pickle file; loading it would run "
                             f"pickle (arbitrary code), which this format "
                             f"never does")
        raise ValueError(f"{path}: not a {FORMAT_NAME} npz checkpoint")
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"].tobytes()).decode())
        if manifest.get("format") != FORMAT_NAME:
            raise ValueError(f"{path}: not a {FORMAT_NAME} file")
        if manifest.get("version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"{path}: checkpoint version {manifest['version']} is newer "
                f"than this build supports ({FORMAT_VERSION})")
        entries = []
        for e in manifest["paths"]:
            leaf = torch.from_numpy(np.array(z[e["name"]]))
            if "dtype" in e:
                if e["dtype"] not in _BY_NAME:
                    raise ValueError(f"{path}: unsupported leaf dtype "
                                     f"{e['dtype']}")
                leaf = leaf.to(_BY_NAME[e["dtype"]])
            entries.append(([tuple(c) for c in e["path"]], leaf))
    if target is None:
        return _reconstruct(entries)
    by_canon = {_canon(comps): leaf for comps, leaf in entries}
    flat = _flatten(target)
    want = [_canon(comps) for comps, _ in flat]
    missing = [c for c in want if c not in by_canon]
    extra = sorted(set(by_canon) - set(want))
    if missing or extra:
        raise ValueError(
            f"{path}: checkpoint does not match the target structure.\n"
            f"  missing from file: {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}\n"
            f"  not in target:     {extra[:5]}"
            f"{'...' if len(extra) > 5 else ''}")
    leaves = [by_canon[c].to(t.device) if isinstance(t, torch.Tensor)
              else by_canon[c] for c, (_, t) in zip(want, flat)]
    return _unflatten_like(target, leaves)
