"""Shared arithmetic of the metric readers under ``metrics/``."""
from lpbench import work


def pe_roofline(run, kernels, backward: bool):
    """The PE + attention op's share of its roofline over the traced
    window: the least time of every recorded call (counted on its valid
    slots; for the backward, the calls under autograd) over the device time
    of the kernels whose names hold one of ``kernels``. None when the
    window launched none of them."""
    if run.trace is None:
        return None
    calls = [c for c in run.pe_calls if c[4] or not backward]
    kernel_s, launches = run.trace.kernel_s(kernels)
    if not calls or kernel_s <= 0 or not launches:
        return None
    bound = work.pe_bwd_least_s if backward else work.pe_fwd_least_s
    least = sum(bound(k, w1, kb, nv) for k, w1, kb, nv, _ in calls)
    return 100.0 * least / kernel_s
