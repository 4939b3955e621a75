"""The cells at tiny sizes on the card, through the program's CUDA kernels:
a sound run is correct, the control one step below the configuration's
precision is not."""
import pytest

from lpbench import cells
from tiny import CELLS, SPEC, tiny


def _run(cell, **kw):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import run as bench_run
    return bench_run.main(
        ["--workload", cell, "--seed", "3000000023", "--seconds", "0.5",
         "--trace", "1"], device="cuda", spec=SPEC, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_card(cell):
    res = _run(cell, overrides=tiny())
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_control_on_card(cell):
    stated = SPEC.config(SPEC.cell(cell)["config"])[0]["matmul_dtype"]
    res = _run(cell, overrides=tiny(), precision=cells.CONTROL[stated])
    assert not res["correct"], res["checks"]
