"""Host seconds of the program's native PPR push: its ``build.ppr_push``
span, in set-up."""
from lpbench import spans


def read(run):
    return spans.span_host_s("build.ppr_push")
