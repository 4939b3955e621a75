"""The combined-table PE + attention backward (row 2 of PERF.md's kernel
table) against its roofline, in the training cells."""
from lpbench.readers import pe_roofline

KERNELS = ("pe_tiles_bwd_kernel", "pe_tiles_dw2_kernel")


def read(run):
    return pe_roofline(run, KERNELS, backward=True)
