"""The combined-table PE + attention forward (row 1 of PERF.md's kernel
table) against its roofline, in the eval cells."""
from lpbench.readers import pe_roofline

KERNELS = ("pe_tiles_fwd_kernel", "pe_fwd_stats_kernel")


def read(run):
    return pe_roofline(run, KERNELS, backward=False)
