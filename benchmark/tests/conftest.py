"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that decide inside themselves whether a card is present."""
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself when none is present")
