"""Process start to the window: loading the libraries, the graph data,
the program's host build and its move to the card, the weights, the
traffic and the warm-up (a training cell's checked steps, an evaluation
cell's first sweep)."""


def read(run):
    return run.setup_s
