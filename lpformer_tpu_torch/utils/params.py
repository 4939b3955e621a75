"""Parameter bridge from the JAX package's pytree to the port.

The port keeps the JAX package's parameter tree as it is: nested dicts and
lists whose leaves are tensors instead of jax arrays. So the layout notes of
``lpformer_tpu/utils/interop.py`` hold unchanged:

  * linear weights are ``[in, out]`` (``y = x @ w + b``), not torch's
    ``[out, in]``;
  * LayerNorm parameters are ``g`` (gain) and ``b`` (bias);
  * an attention layer's ``att`` is ``[H, O]``;
  * an MLP has ONE ``norm`` shared by all of its hidden layers
    (``lpformer_tpu/nn/core.py:164-183``).
"""
from __future__ import annotations

import numpy as np
import torch

from lpformer_tpu_torch import resolve_device


def from_jax_params(tree, device=None):
    """Port params from the pytree of ``init_lpformer`` after
    ``jax.tree.map(np.asarray, params)``: the same nesting, with every
    array leaf a float32 (or its own dtype) tensor on ``device``."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return torch.as_tensor(np.array(node)).to(dev)

    return walk(tree)


def from_jax_opt_state(state, device=None):
    """Port the JAX package's fused-Adam state (``train/optim.py:95-100``,
    ``{count, m, v, score_mask}`` with m, v and score_mask flat over the
    parameters in ``ravel_pytree`` order) after ``jax.tree.map(np.asarray,
    state)``: the port's fused optimizer flattens in the same order, so the
    vectors carry over as they are."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(np.array(state[k])).to(dev)
           for k in ("m", "v", "score_mask")}
    out["count"] = torch.as_tensor(np.array(state["count"]),
                                   dtype=torch.int32).to(dev)
    return out
