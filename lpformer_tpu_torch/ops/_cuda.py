"""Build, binding and argument checks shared by the CUDA kernel wrappers
in ``ops/``: each kernel is a CUDA C++ source under ``csrc/`` with a plain
C interface, compiled with nvcc for sm_90a at first use (utils/build.py)
and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import torch

from lpformer_tpu_torch.utils.build import build_shared, find_nvcc

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_cuda(name: str, source: str, headers: Sequence[str] = ()
               ) -> Tuple[str, str]:
    """Compile ``csrc/{source}`` into ``lib{name}`` (cached by the hash of
    the source and the ``headers`` under ``csrc/`` it includes). Returns
    (library path, compiler output, which holds ptxas's register and spill
    report)."""
    return build_shared(name, [os.path.join(CSRC, source)],
                        [find_nvcc()] + NVCC_FLAGS,
                        [os.path.join(CSRC, h) for h in headers])


def bind(path, fn, n_ptr, n_int, err_fn):
    """The library at ``path`` with ``fn``(n_ptr pointers, n_int ints,
    stream) -> error code and ``err_fn``(error code) -> message typed for
    ctypes."""
    lib = ctypes.CDLL(path)
    getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, fn).argtypes = ([ctypes.c_void_p] * n_ptr
                                 + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    getattr(lib, err_fn).restype = ctypes.c_char_p
    getattr(lib, err_fn).argtypes = [ctypes.c_int]
    return lib


def check_tensors(keys, want):
    """Raise unless every ``want[name] = (tensor, dtype, shape)`` lies on
    keys' device, contiguous, 16-byte aligned and of that dtype and shape,
    and keys are bf16 or f32. The kernels take any O and dh."""
    if keys.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"keys must be bfloat16 or float32, got {keys.dtype}")
    for name, (t, dtype, shape) in want.items():
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on {keys.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
