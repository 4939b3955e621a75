"""Host seconds of the program's graph-bundle build, from the symmetrised
edges to the bundle on the device: its ``build.bundle`` span, in
set-up."""
from lpbench import spans


def read(run):
    return spans.span_host_s("build.bundle")
