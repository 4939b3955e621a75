"""Compile native sources into shared libraries under ``BUILD_DIR``.

Each library's file name carries a hash of its sources and its command
line, so an edited source is rebuilt and an unchanged one is reused. The
compiler writes to a private temporary name that is renamed into place,
so concurrent builders (test workers) never load a half-written file.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence, Tuple

from lpformer_tpu_torch import BUILD_DIR


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not on PATH: the CUDA kernels cannot be built")
    return nvcc


def build_shared(
    name: str, sources: Sequence[str], compiler: Sequence[str],
    headers: Sequence[str] = (),
) -> Tuple[str, str]:
    """Build ``sources`` with ``compiler + [-o out] + sources`` into
    ``BUILD_DIR/lib{name}-{hash}.so`` unless it exists; the hash also
    covers the ``headers`` the sources include. Returns (path, compiler
    output; empty when the library was already built). Raises
    RuntimeError with the compiler's output on failure."""
    h = hashlib.sha1(" ".join(compiler).encode())
    for src in list(sources) + list(headers):
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            list(compiler) + ["-o", tmp] + list(sources),
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(compiler)}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr
