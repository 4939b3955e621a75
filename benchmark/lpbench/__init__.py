"""The benchmark's harness: cells, traffic, the program's entry points, the
checks against the reference, and the reduction of traces to metrics."""
