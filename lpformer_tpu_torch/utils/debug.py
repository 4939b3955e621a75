"""Debug utilities: NaN checks and finite-tree assertions behind a flag
(counterpart of ``lpformer_tpu/utils/debug.py``).

``LPFORMER_TPU_DEBUG_NANS`` set (to anything non-empty) turns the checks
on, under the JAX package's name. The counterpart of ``jax_debug_nans``
is ``torch.autograd.set_detect_anomaly``: the backward then raises at the
first operation that produced a NaN, naming its forward.
"""
from __future__ import annotations

import os

import torch

from lpformer_tpu_torch.train.optim import tree_leaves_with_path


def nan_checks_enabled() -> bool:
    return bool(os.environ.get("LPFORMER_TPU_DEBUG_NANS"))


def enable_nan_checks():
    """Process-wide NaN detection in the backward (slow: every autograd
    node checks its outputs and keeps its forward's stack)."""
    torch.autograd.set_detect_anomaly(True)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def assert_tree_finite(tree, name: str = "tree"):
    """Raise FloatingPointError naming the first floating leaf of a nested
    dict / list of tensors that holds a NaN or an infinity."""
    for path, leaf in tree_leaves_with_path(tree):
        if (torch.is_tensor(leaf) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            raise FloatingPointError(
                f"non-finite values in {name}{_keystr(path)}")


def debug_check_finite(x, label: str = "x"):
    """With the checks on, print whether ``x`` holds a non-finite value
    (a host synchronisation); ``x`` is returned unchanged either way."""
    if not nan_checks_enabled():
        return x
    bad = not bool(torch.isfinite(x).all())
    print(f"NaN-check {label}: non_finite={bad}", flush=True)
    return x
