"""Functional NN primitives (counterpart of ``lpformer_tpu/nn/core.py``).

Parameters are nested dicts of tensors in the JAX package's layout
(``utils/params.py``); the applies are plain functions on tensors.

The bf16 matmul policy is the JAX package's: bf16 INPUTS, float32
accumulation, float32 output (``jnp.dot(..., preferred_element_type=f32)``).
A ``torch.matmul`` on bf16 tensors would round its output to bf16 as well,
so :func:`matmul` instead runs a float32 product of the bf16-rounded inputs
(TF32 is off, see the package ``__init__``): the products of two bf16
values are exact in float32, and only the summation order differs from the
reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def uniform_init(
    gen: torch.Generator, shape, bound: float, device=None
) -> torch.Tensor:
    """U(-bound, bound) drawn on the CPU from ``gen``, then moved, so a
    seed gives the same values on every device."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def linear_init(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    bias: bool = True,
    kind: str = "torch",
    device=None,
) -> Dict[str, torch.Tensor]:
    """``kind="torch"``: U(+-1/sqrt(fan_in)) for weight and bias (torch
    Linear). ``kind="glorot"``: U(+-sqrt(6/(fan_in+fan_out))) weight with the
    U(+-1/sqrt(fan_in)) bias of PyG's Linear."""
    if kind == "torch":
        bound = 1.0 / (in_dim ** 0.5)
    elif kind == "glorot":
        bound = (6.0 / (in_dim + out_dim)) ** 0.5
    else:
        raise ValueError(f"unknown init kind: {kind}")
    p = {"w": uniform_init(gen, (in_dim, out_dim), bound, device)}
    if bias:
        p["b"] = uniform_init(gen, (out_dim,), 1.0 / (in_dim ** 0.5), device)
    return p


def matmul(x: torch.Tensor, w: torch.Tensor, mm_dtype=None) -> torch.Tensor:
    """``x @ w``; with ``mm_dtype`` (bf16) the inputs are rounded to it and
    the product is accumulated and returned in float32."""
    if mm_dtype is None:
        return x @ w
    return x.to(mm_dtype).float() @ w.to(mm_dtype).float()


def cast_matmul_weights(params, mm_dtype):
    """Pre-round every matmul kernel (2-D+ ``"w"`` leaf) to ``mm_dtype``,
    as the reference does once per program."""
    if mm_dtype is None:
        return params

    def walk(d):
        if isinstance(d, dict):
            return {
                k: (v.to(mm_dtype)
                    if k == "w" and torch.is_tensor(v) and v.dim() >= 2
                    else walk(v))
                for k, v in d.items()
            }
        if isinstance(d, (list, tuple)):
            return type(d)(walk(x) for x in d)
        return d

    return walk(params)


def linear_apply(params: Dict, x: torch.Tensor, mm_dtype=None) -> torch.Tensor:
    y = matmul(x, params["w"], mm_dtype)
    if "b" in params:
        y = y + params["b"]
    return y


def layer_norm_init(dim: int, device=None) -> Dict[str, torch.Tensor]:
    return {
        "g": torch.ones(dim, dtype=torch.float32, device=device),
        "b": torch.zeros(dim, dtype=torch.float32, device=device),
    }


def layer_norm_apply(
    params: Dict, x: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * params["g"] + params["b"]


def dropout(
    gen: Optional[torch.Generator], x: torch.Tensor, rate: float, train: bool
) -> torch.Tensor:
    """Inverted dropout (torch semantics: scale by 1/(1-p) at train). The
    keep mask is drawn from ``gen``, a generator on x's device; without
    one, or at eval, x passes unchanged."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def mlp_init(
    gen: torch.Generator,
    num_layers: int,
    in_dim: int,
    hid_dim: int,
    out_dim: int,
    norm: str = "layer",
    bias: bool = True,
    device=None,
) -> Dict:
    """L-layer MLP: hidden layers are [Linear -> shared norm -> relu], the
    final layer a bare Linear (reference src/models/other_models.py:80-138)."""
    p: Dict = {"layers": []}
    if num_layers == 1:
        p["layers"].append(linear_init(gen, in_dim, out_dim, bias, device=device))
    else:
        p["layers"].append(linear_init(gen, in_dim, hid_dim, bias, device=device))
        for _ in range(num_layers - 2):
            p["layers"].append(
                linear_init(gen, hid_dim, hid_dim, bias, device=device))
        p["layers"].append(linear_init(gen, hid_dim, out_dim, bias, device=device))
    if norm == "layer" and num_layers > 1:
        p["norm"] = layer_norm_init(hid_dim, device)
    return p


def mlp_apply(
    params: Dict,
    x: torch.Tensor,
    drop: float = 0.0,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    sigmoid: bool = False,
    mm_dtype=None,
) -> torch.Tensor:
    """Hidden layers [Linear -> norm -> relu -> dropout(drop)], then the
    bare last Linear; a last dim of 1 is squeezed."""
    layers = params["layers"]
    for lp in layers[:-1]:
        x = linear_apply(lp, x, mm_dtype)
        if "norm" in params:
            x = layer_norm_apply(params["norm"], x)
        x = torch.relu(x)
        x = dropout(gen, x, drop, train)
    x = linear_apply(layers[-1], x, mm_dtype)
    if x.shape[-1] == 1:
        x = x.squeeze(-1)
    return torch.sigmoid(x) if sigmoid else x
