"""Device time of the PE + attention op's backward a training step: the
window's kernels charged to the program's ``model.pe_attention.bwd`` span
(the dkeys fill, rows 2 / 5 and the key table's gradient sum, row 3;
lpbench/spans.py), over the window's steps."""
from lpbench import spans


def read(run):
    a = spans.attribution(run)
    if a is None or not any("model.pe_attention.bwd" in p.split("/")
                            for p in a.charged):
        return None
    return spans.per_sweep_ms(run, a.device_s("model.pe_attention.bwd"))
