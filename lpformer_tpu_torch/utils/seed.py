"""Process-wide seeding (counterpart of ``lpformer_tpu/utils/seed.py``).

The reference's ``init_seed`` (reference: src/util/utils.py:11-17) seeds
python ``random``, numpy and torch. The JAX package does the same and
asks torch for deterministic algorithms with ``warn_only=True``, a flag
that reaches only torch's CPU ops there, since its compute runs in JAX.
The port keeps that effect: the flag is set when the run's device is the
CPU. On CUDA it is left as it is, because there it would swap the context
compaction's ``scatter_`` and the ``index_add_`` calls for PyTorch's
sort-based ``index_put_`` and fill new memory with NaN, which makes the
collab CLI step 2.19x slower (PERF.md §5). Either way the fused
PE+attention forward adds a link's partial sums with f32 atomics, so eval
scores on the card agree from run to run to their last bits, not bit
for bit (chip_smoke.py phase 12 holds them to CKPT_SCORE_TOL).
"""
from __future__ import annotations

import random

import numpy as np
import torch


def init_seed(seed: int, device="cpu") -> None:
    """Seed ``random``, numpy and torch (the CPU generator and every CUDA
    device's); on a CPU ``device`` also turn on torch's deterministic
    algorithms, warn-only, as the JAX package does."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.device(device).type == "cpu":
        torch.use_deterministic_algorithms(True, warn_only=True)
