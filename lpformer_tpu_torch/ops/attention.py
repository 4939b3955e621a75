"""Fused per-link GATv2 attention without PE, forward and backward
(counterpart of ``lpformer_tpu/ops/pallas/attention.py:
fused_link_attention``, heads == 1).

For each link b over its valid context slots c:

  xj     = keys[b,c] @ W_r + r_bias
  s      = att . leaky_relu_0.2(xj * q[b])
  out[b] = sum_c softmax_c(s) xj + bias;  m[b], l[b] the softmax stats

``fused_link_attention`` is a ``torch.autograd.Function``. Its forward
launches the hand-written CUDA kernel ``csrc/link_attention_fwd.cu`` on
CUDA tensors (built with nvcc for sm_90a at first use, loaded with ctypes;
a block takes whole links, in chunks of up to 128 valid slots, with the
products on tensor cores in bf16 and as exact f32 FMA tiles in f32:
``csrc/link_attention_tiles.cuh``)
and runs ``fused_link_attention_plain``, the same math in torch ops over
[B, C], on CPU tensors. Its backward, from the saved m, l and out, is
``fused_link_attention_bwd``: the CUDA kernels
``csrc/link_attention_bwd.cu`` on CUDA tensors,
``fused_link_attention_bwd_plain`` on CPU tensors. There is no fallback
between kernel and plain version. delta = g_out . (out - bias) and dbias =
sum_b g_out are computed in torch, as the JAX package's ``_fused_bwd``.

As in the JAX entry, keys and W_r run in the keys' type (bf16 keys take
W_r rounded to bf16; products accumulate in f32), q in f32, and the key
cotangent dxj is rounded to the keys' type before the dkeys and dW
products (attention.py:203-210); dkeys is in the keys' type and dW is
rounded to it before it flows back to W_r's own type.
"""
from __future__ import annotations

from typing import Tuple

import torch

from lpformer_tpu_torch.ops._cuda import bind, build_cuda, check_tensors
from lpformer_tpu_torch.ops.pe_attention_mixed import (
    attend, attend_backward, backward_cotangent,
)

_HEADERS = ("pe_attention_common.cuh", "pe_attention_tiles.cuh",
            "link_attention_tiles.cuh")
_LIB = None
_LIB_BWD = None


def build() -> Tuple[str, str]:
    """Compile the forward kernel (cached by source hash). Returns (library
    path, compiler output, which holds ptxas's register and spill report)."""
    return build_cuda("link_attention_fwd", "link_attention_fwd.cu",
                      _HEADERS)


def build_bwd() -> Tuple[str, str]:
    """Compile the backward kernels, as :func:`build`."""
    return build_cuda("link_attention_bwd", "link_attention_bwd.cu",
                      _HEADERS)


def _load():
    global _LIB
    if _LIB is None:
        _LIB = bind(build()[0], "link_attention_fwd", 10, 5,
                    "link_attention_error_string")
    return _LIB


def _load_bwd():
    global _LIB_BWD
    if _LIB_BWD is None:
        _LIB_BWD = bind(build_bwd()[0], "link_attention_bwd", 16, 5,
                        "link_attention_bwd_error_string")
    return _LIB_BWD


def _xj(keys, w, r_bias):
    """keys @ W_r + r_bias in f32 ([B, C, O]): bf16 products are exact in
    f32, so only the summation order differs from an f32-accumulating
    bf16 product."""
    return keys.float() @ w.float() + r_bias


def fused_link_attention_plain(keys, q, valid, w, r_bias, att, bias
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The kernel's math in torch ops over [B, C]. Returns (out [B, O],
    m [B], l [B])."""
    return attend(_xj(keys, w, r_bias), valid, q, att, bias)


def fused_link_attention_bwd_plain(keys, q, valid, w, r_bias, att, m, l,
                                   g_out, delta):
    """The backward kernels' math in torch ops, with the TPU kernel's
    rounding point: dxj rounded to the keys' type before both products.
    Returns (dkeys [B, C, Dk] keys' dtype, dq [B, O], dw [Dk, O] f32,
    drb [O], datt [1, O])."""
    dxj, dq, datt = attend_backward(_xj(keys, w, r_bias), valid, q, att, m,
                                    l, g_out, delta)
    dxc = dxj.to(keys.dtype).float()
    dkeys = (dxc @ w.float().T).to(keys.dtype)
    dk = keys.shape[-1]
    dw = keys.float().reshape(-1, dk).T @ dxc.reshape(-1, dxc.shape[-1])
    return dkeys, dq, dw, dxj.sum((0, 1)), datt


def _check(keys, q, valid, w, r_bias, att, bias=None, **extra):
    """Dtypes, shapes, devices, contiguity and alignment the kernels take;
    ``bias`` is the forward's, ``extra`` holds the backward's further f32
    inputs by name (g_out [B, O], m, l, delta [B])."""
    bsz, c, dk = keys.shape
    o = w.shape[-1]
    per_link = {"g_out": (bsz, o), "m": (bsz,), "l": (bsz,),
                "delta": (bsz,)}
    want = {
        "keys": (keys, keys.dtype, (bsz, c, dk)),
        "q": (q, torch.float32, (bsz, o)),
        "valid": (valid, torch.bool, (bsz, c)),
        "w": (w, keys.dtype, (dk, o)),
        "r_bias": (r_bias, torch.float32, (o,)),
        "att": (att, torch.float32, (1, o)),
    }
    if bias is not None:
        want["bias"] = (bias, torch.float32, (o,))
    for name, t in extra.items():
        want[name] = (t, torch.float32, per_link[name])
    check_tensors(keys, want)


def _fwd(keys, q, valid, w, r_bias, att, bias
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, l): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Counts its launches in ``fused_link_attention.launches``."""
    args = (keys, q, valid, w, r_bias, att, bias)
    if keys.device.type == "cpu":
        return fused_link_attention_plain(*args)
    _check(*args)
    bsz, c, dk = keys.shape
    o = w.shape[-1]
    f32 = dict(dtype=torch.float32, device=keys.device)
    out = torch.empty((bsz, o), **f32)
    m = torch.empty((bsz,), **f32)
    l = torch.empty((bsz,), **f32)
    lib = _load()
    with torch.cuda.device(keys.device):
        err = lib.link_attention_fwd(
            *[t.data_ptr() for t in args], out.data_ptr(), m.data_ptr(),
            l.data_ptr(), bsz, c, dk, o,
            int(keys.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("link_attention_fwd launch failed: "
                           + lib.link_attention_error_string(err).decode())
    fused_link_attention.launches += 1
    return out, m, l


def fused_link_attention_bwd(keys, q, valid, w, r_bias, att, m, l, g_out,
                             delta):
    """The backward of the op, as the plain version returns it. CUDA
    tensors launch the kernels (``fused_link_attention_bwd.launches``
    counts the calls); CPU tensors run the plain version."""
    args = (keys, q, valid, w, r_bias, att, m, l, g_out, delta)
    if keys.device.type == "cpu":
        return fused_link_attention_bwd_plain(*args)
    _check(keys, q, valid, w, r_bias, att, g_out=g_out, m=m, l=l,
           delta=delta)
    bsz, c, dk = keys.shape
    o = w.shape[-1]
    dev = keys.device
    f32 = dict(dtype=torch.float32, device=dev)
    dkeys = torch.empty(keys.shape, dtype=keys.dtype, device=dev)
    dxc = torch.empty((bsz, c, o), dtype=keys.dtype, device=dev)  # scratch
    dq = torch.empty((bsz, o), **f32)
    dw = torch.zeros((dk, o), **f32)
    drb = torch.zeros((o,), **f32)
    datt = torch.zeros((1, o), **f32)
    lib = _load_bwd()
    with torch.cuda.device(dev):
        err = lib.link_attention_bwd(
            keys.data_ptr(), q.data_ptr(), valid.data_ptr(),
            g_out.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
            w.data_ptr(), r_bias.data_ptr(), att.data_ptr(),
            dkeys.data_ptr(), dxc.data_ptr(), dq.data_ptr(), dw.data_ptr(),
            drb.data_ptr(), datt.data_ptr(), bsz, c, dk, o,
            int(keys.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("link_attention_bwd launch failed: "
                           + lib.link_attention_bwd_error_string(err).decode())
    fused_link_attention_bwd.launches += 1
    return dkeys, dq, dw, drb, datt


fused_link_attention_bwd.launches = 0


class LinkAttentionOp(torch.autograd.Function):
    """The differentiable op over a (forward, backward) pair of
    implementations: ``fused_link_attention`` passes the kernel wrappers.
    Returns out; valid carries no gradient."""

    @staticmethod
    def forward(ctx, fwd, bwd, keys, q, valid, w, r_bias, att, bias):
        args = (keys, q, valid, w, r_bias, att, bias)
        out, m, l = fwd(*args)
        ctx.bwd = bwd
        ctx.save_for_backward(*args, m, l, out)
        return out

    @staticmethod
    def backward(ctx, g_out):
        keys, q, valid, w, r_bias, att, bias, m, l, out = ctx.saved_tensors
        g_out, delta = backward_cotangent(g_out, out, bias)
        dkeys, dq, dw, drb, datt = ctx.bwd(keys, q, valid, w, r_bias, att, m,
                                           l, g_out, delta)
        return (None, None, dkeys, dq, None, dw.to(w.dtype), drb, datt,
                g_out.sum(0))


def prepare(keys, q, valid, w_r, r_bias, att, bias):
    """The JAX entry's argument preparation: keys and W_r in the keys' type
    (bf16 or f32), the rest f32 and contiguous. Differentiable casts, so
    the grads flow back to each argument's own type."""
    kdt = torch.bfloat16 if keys.dtype == torch.bfloat16 else torch.float32
    f = lambda t: t.float().contiguous()  # noqa: E731
    return (keys.to(kdt).contiguous(), f(q), valid.bool().contiguous(),
            w_r.to(kdt).contiguous(), f(r_bias), f(att).reshape(1, -1),
            f(bias))


def fused_link_attention(
    keys: torch.Tensor,    # [B, C, Dk] node feats || pe, bf16 or f32
    q: torch.Tensor,       # [B, O]     lin_l(e1) + lin_l(e2)
    valid: torch.Tensor,   # [B, C] bool
    w_r: torch.Tensor,     # [Dk, O]
    r_bias: torch.Tensor,  # [O]        lin_r bias
    att: torch.Tensor,     # [1, O]
    bias: torch.Tensor,    # [O]        output bias
    heads: int = 1,
) -> torch.Tensor:
    """out [B, O] f32, differentiable in keys, q, w_r, r_bias, att and bias
    (as the JAX entry, which returns out alone). CUDA tensors launch the
    kernels (``.launches`` on this function counts the forward's, on
    ``fused_link_attention_bwd`` the backward's); CPU tensors run the plain
    versions."""
    if heads != 1:
        raise NotImplementedError("the fused kernel takes num_heads == 1, "
                                  "as the JAX package's")
    return LinkAttentionOp.apply(_fwd, fused_link_attention_bwd,
                                 *prepare(keys, q, valid, w_r, r_bias, att,
                                          bias))


fused_link_attention.launches = 0
