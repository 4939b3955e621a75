"""Optimizer: Adam + exponential epoch decay + partitioned grad clipping
(counterpart of ``lpformer_tpu/train/optim.py``), fused on one flat vector.

Mirrors the reference training setup (reference:
src/train/train_model.py:73-77,99-100):
  * grad-norm clip to 1.0, applied separately to the score head and to the
    rest of the model (the reference calls clip_grad_norm_ once per
    module);
  * torch.optim.Adam semantics: L2 weight decay added to the gradient
    before the moment updates (not AdamW);
  * LambdaLR(decay ** epoch): lr(step) = lr0 * decay^(step // steps_per_epoch),
    on the pre-increment step count.

The transformation is functional, as optax's: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, with params, grads
and updates nested dicts and lists of tensors. The flat vector follows the
JAX package's ``ravel_pytree`` order (dict keys sorted, lists in order), so
its state ``{count, m, v, score_mask}`` carries over element for element
(``utils/params.from_jax_opt_state``). Plain torch: the reference runs it
as XLA, not as a kernel.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) pairs in ``ravel_pytree`` order: dict keys sorted,
    lists and tuples in order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def tree_leaves(tree) -> List[torch.Tensor]:
    return [x for _, x in tree_leaves_with_path(tree)]


def tree_map_with_path(fn, tree, path: Tuple = ()):
    """The same structure with every leaf x replaced by fn(path, x)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree):
    return tree_map_with_path(lambda _, x: fn(x), tree)


def ravel(tree) -> torch.Tensor:
    """All leaves as one flat float32 vector, in ``ravel_pytree`` order."""
    return torch.cat([x.reshape(-1).float() for x in tree_leaves(tree)])


def unravel(flat: torch.Tensor, like):
    """The inverse of :func:`ravel` onto the structure of ``like``."""
    pairs = tree_leaves_with_path(like)
    parts = dict(zip([p for p, _ in pairs],
                     torch.split(flat, [x.numel() for _, x in pairs])))
    return tree_map_with_path(
        lambda p, x: parts[p].reshape(x.shape).to(x.dtype), like)


def _is_score(path) -> bool:
    return len(path) > 0 and path[0] == "score"


def fused_adam_with_partitioned_clip(
    lr: float,
    weight_decay: float,
    decay: float,
    steps_per_epoch: int,
    clip_norm: Optional[float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> GradientTransformation:
    """The full chain (partitioned clip -> torch-Adam -> lr schedule) on one
    flat parameter vector: two norms and one elementwise chain."""

    def init_fn(params):
        pairs = tree_leaves_with_path(params)
        flat = ravel(params)
        mask = torch.cat([
            torch.full((x.numel(),), float(_is_score(p)),
                       dtype=flat.dtype, device=flat.device)
            for p, x in pairs])
        return {
            "count": torch.zeros((), dtype=torch.int32, device=flat.device),
            "m": torch.zeros_like(flat),
            "v": torch.zeros_like(flat),
            "score_mask": mask,
        }

    def update_fn(updates, state, params=None):
        g = ravel(updates)
        mask = state["score_mask"]
        if clip_norm is not None:
            # two independent global-norm clips (reference calls
            # clip_grad_norm_ once per module, train_model.py:73-77)
            ss = (g * g * mask).sum()
            sr = (g * g).sum() - ss
            cs = (clip_norm / ss.sqrt().clamp_min(1e-12)).clamp_max(1.0)
            cr = (clip_norm / sr.sqrt().clamp_min(1e-12)).clamp_max(1.0)
            g = g * (mask * cs + (1.0 - mask) * cr)
        if weight_decay > 0:
            g = g + weight_decay * ravel(params)
        c = state["count"] + 1
        m = b1 * state["m"] + (1.0 - b1) * g
        v = b2 * state["v"] + (1.0 - b2) * g * g
        cf = c.to(m.dtype)
        mhat = m / (1.0 - torch.pow(b1, cf))
        vhat = v / (1.0 - torch.pow(b2, cf))
        upd = mhat / (vhat.sqrt() + eps)
        # LambdaLR(decay ** epoch) on the PRE-increment count (optax
        # scale_by_schedule semantics: the first update sees schedule(0))
        epoch = torch.div(state["count"], max(steps_per_epoch, 1),
                          rounding_mode="floor")
        lr_t = lr * torch.pow(decay, epoch.to(m.dtype))
        new_state = {"count": c, "m": m, "v": v, "score_mask": mask}
        return unravel(-lr_t * upd, updates), new_state

    return GradientTransformation(init_fn, update_fn)


def make_optimizer(
    lr: float,
    weight_decay: float = 0.0,
    decay: float = 1.0,
    steps_per_epoch: int = 1,
    clip_norm: Optional[float] = 1.0,
) -> GradientTransformation:
    """The fused flat-vector chain, the JAX package's ``fused=True``. Its
    reference-shaped optax chain (``fused=False``), against which it tests
    the fused one, is not ported."""
    return fused_adam_with_partitioned_clip(
        lr, weight_decay, decay, steps_per_epoch, clip_norm)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """params += updates, in place (optax.apply_updates builds new arrays;
    the port updates its leaves so autograd keeps the same tensors)."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u)
