"""Reference-checkpoint interop (counterpart of
``lpformer_tpu/utils/interop.py``).

Converts the reference's torch ``state_dict`` layout
(reference: src/util/utils.py:21-51: ``{"model": LinkTransformer
state_dict, "score_func": mlp_score state_dict, "optimizer": ...}``) into
the port's parameter tree (``models/link_transformer.py:init_lpformer``,
the JAX package's tree with tensor leaves).

The mapping is structural, not numeric: torch ``Linear.weight`` is
[out, in] and the port's ``w`` is [in, out] (transposed); LayerNorm
``weight/bias`` -> ``g/b``; the GATv2 ``att`` parameter drops its leading
broadcast dim ([1, H, O] -> [H, O]). The reference's
``node_encoder.feat_transform`` is constructed but never used in its
forward (reference: src/modules/node_encoder.py:27), so import drops it.
The JAX package's ``export_reference_state`` (the inverse) has no
counterpart here: nothing in the port writes a reference checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.train.optim import tree_map

__all__ = ["import_reference_state"]


def _t(x: Any) -> torch.Tensor:
    """A copy of a tensor (on its device) or of a numpy array / number as
    a tensor: the result shares no memory with the state it came from."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.as_tensor(np.array(x))


def _lin_in(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """torch Linear -> {"w" [in, out], "b"}."""
    out = {"w": _t(sd[prefix + ".weight"]).t().contiguous()}
    if prefix + ".bias" in sd:
        out["b"] = _t(sd[prefix + ".bias"])
    return out


def _ln_in(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {"g": _t(sd[prefix + ".weight"]), "b": _t(sd[prefix + ".bias"])}


def _mlp_in(sd: Mapping[str, Any], prefix: str, lin_name: str = "linears",
            norm: bool = True) -> Dict:
    """Reference MLP / mlp_score (reference: src/models/other_models.py:
    80-138, 142-179) -> the port's mlp param dict."""
    base = f"{prefix}.{lin_name}" if prefix else lin_name
    norm_base = f"{prefix}.norm" if prefix else "norm"
    layers: List[Dict] = []
    i = 0
    while f"{base}.{i}.weight" in sd:
        layers.append(_lin_in(sd, f"{base}.{i}"))
        i += 1
    if not layers:
        raise KeyError(f"no '{base}.*.weight' keys found")
    p: Dict = {"layers": layers}
    if norm and f"{norm_base}.weight" in sd:
        p["norm"] = _ln_in(sd, norm_base)
    return p


def _att_layer_in(sd: Mapping[str, Any], prefix: str) -> Dict:
    """Reference LinkTransformerLayer (reference: src/modules/layers.py:
    17-157): .att.{lin_l,lin_r,att,bias} + .post_att_norm."""
    att = _t(sd[f"{prefix}.att.att"])
    if att.ndim == 3:  # [1, H, O] -> [H, O]
        att = att[0]
    return {
        "lin_l": _lin_in(sd, f"{prefix}.att.lin_l"),
        "lin_r": _lin_in(sd, f"{prefix}.att.lin_r"),
        "att": att,
        "bias": _t(sd[f"{prefix}.att.bias"]),
        "post_norm": _ln_in(sd, f"{prefix}.post_att_norm"),
    }


def import_reference_state(state: Mapping[str, Any], device=None) -> Dict:
    """``{"model": state_dict, "score_func": state_dict}`` (values: tensors
    or numpy arrays) -> the port's parameter tree on ``device`` (default
    CUDA).

    Mask mode and layer counts are inferred from which keys exist, so the
    result matches whatever config the checkpoint was trained with."""
    dev = resolve_device(device)
    msd = state["model"]
    ssd = state["score_func"]

    p: Dict = {}
    # GCN encoder (reference: other_models.py:10-76 under
    # node_encoder.gnn_encoder; conv = PyG GCNConv: lin.weight + bias)
    convs: List[Dict] = []
    lns: List[Dict] = []
    i = 0
    while f"node_encoder.gnn_encoder.convs.{i}.lin.weight" in msd:
        c = _lin_in(msd, f"node_encoder.gnn_encoder.convs.{i}.lin")
        c["bias"] = _t(msd[f"node_encoder.gnn_encoder.convs.{i}.bias"])
        convs.append(c)
        if f"node_encoder.gnn_encoder.lns.{i}.weight" in msd:
            lns.append(_ln_in(msd, f"node_encoder.gnn_encoder.lns.{i}"))
        i += 1
    if not convs:
        raise KeyError("no GCN conv weights in checkpoint['model']")
    enc: Dict = {"convs": convs}
    if lns:
        enc["lns"] = lns
    p["node_encoder"] = enc

    p["gnn_norm"] = _ln_in(msd, "gnn_norm")
    p["elementwise_lin"] = _mlp_in(msd, "elementwise_lin")
    p["ppr_encoder_cn"] = _mlp_in(msd, "ppr_encoder_cn")
    for name in ("ppr_encoder_onehop", "ppr_encoder_non1hop"):
        if f"{name}.linears.0.weight" in msd:
            p[name] = _mlp_in(msd, name)

    att_layers: List[Dict] = []
    li = 0
    while f"att_layers.{li}.att.lin_l.weight" in msd:
        att_layers.append(_att_layer_in(msd, f"att_layers.{li}"))
        li += 1
    if not att_layers:
        raise KeyError("no att_layers.* weights in checkpoint['model']")
    p["att_layers"] = att_layers

    p["pairwise_lin"] = _mlp_in(msd, "pairwise_lin")
    # mlp_score uses attribute name "lins" and has no norm
    # (reference: other_models.py:152-156)
    p["score"] = _mlp_in(ssd, "", lin_name="lins", norm=False)
    return tree_map(lambda t: t.to(dev), p)
