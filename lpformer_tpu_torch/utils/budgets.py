"""Measured context budgets (counterpart of ``lpformer_tpu/utils/budgets.py``).

The reference's context sets are unbounded; the classic table pads them
to static per-class budgets, and the right budgets are a property of the
dataset (PPR eps, thresholds, degree distribution). So they are measured:
sample train links, extract the exact pre-truncation class counts
(``ContextTables.counts`` does not depend on the budgets, ops/context.py),
and take each class's p99.9 rounded up to a multiple of 32, clamped to
what the padded rows can supply. The JAX CLI does this by default when no
``--budget-*`` is given. Here the extraction runs on the dataset's device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _rec(p999: float, lo: int, hi: int, align: int = 32) -> int:
    """p99.9 rounded up to a multiple of ``align``, clamped to [lo, hi]
    (hi = what the padded rows can supply). The JAX package aligns to 32
    so its Pallas kernel can tile the context axis; the port's kernels
    take any widths, and the same rounding keeps both packages' budgets
    equal."""
    b = max(align, int(-(-int(p999) // align) * align))
    return int(min(max(b, lo), hi))


def derive_budgets(
    ds,
    thresh_cn: float,
    thresh_1hop: float,
    thresh_non1hop: float,
    sample: int = 2048,
    seed: int = 0,
    include_combined: bool = False,
) -> Tuple[int, ...]:
    """Measured (budget_cn, budget_onehop, budget_non1hop) for this dataset
    at these thresholds. With ``include_combined`` a 4th element is
    appended: the p99.9 of the TOTAL per-link count, the combined
    (class-tagged) table's budget (ContextConfig.budget_combined), which
    is typically far below the summed per-class budgets."""
    from lpformer_tpu_torch.ops.context import ContextConfig, extract_context

    g = ds.graph
    adj_cap, ppr_cap = g.adj_rows.cap, g.ppr_rows.cap
    cfg = ContextConfig.from_thresholds(
        thresh_cn, thresh_1hop, thresh_non1hop,
        # the measurement budgets do not change .counts (exact
        # pre-truncation); small ones keep the probe cheap
        budget_cn=min(32, adj_cap),
        budget_onehop=min(32, 2 * adj_cap),
        budget_non1hop=min(32, ppr_cap),
    )
    tp = np.asarray(ds.train_pos)
    take = min(sample, len(tp))
    idx = np.random.default_rng(seed).choice(len(tp), take, replace=False)
    links = torch.as_tensor(tp[idx]).to(g.x.device)
    with torch.no_grad():
        ctx = extract_context(g.adj_rows, g.ppr_rows, links[:, 0],
                              links[:, 1], cfg)
    counts = ctx.counts.cpu().numpy()
    q = lambda col: float(np.percentile(col, 99.9))  # noqa: E731
    # class-count ceilings set by what the padded rows can supply: CNs
    # come from one adjacency row (<= adj_cap); 1-hop from both endpoints'
    # rows (<= 2*adj_cap); >1-hop from the PPR support (<= ppr_cap)
    b_cn = _rec(q(counts[:, 0]), 32, adj_cap)
    b_oh = _rec(q(counts[:, 1]), 32, 2 * adj_cap)
    b_n1 = _rec(q(counts[:, 2]), 32, ppr_cap)
    if not include_combined:
        return b_cn, b_oh, b_n1
    total = counts[:, 0] + counts[:, 1] + counts[:, 2]
    b_all = _rec(q(total), 32, 2 * adj_cap + ppr_cap)
    return b_cn, b_oh, b_n1, b_all
