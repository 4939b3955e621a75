"""The host clock around the program's graph build (PPR push, train-edge
ranks, capped rows, SpMM layout, the move to the card): part of set-up."""


def read(run):
    return run.host_build_s
