"""The port's measured context budgets against lpformer_tpu's: the same
synthetic graph, thresholds and sample give the same budgets (exact: the
context counts they are taken from are equal, tests/test_torch_context.py),
in the three mask modes and with the combined budget."""
import numpy as np
import pytest

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.utils import budgets as jbudgets
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.utils import budgets as tbudgets

KW = dict(seed=1, num_nodes=300, num_train=3000, num_eval=20, feat_dim=4,
          eps=1e-3, adj_cap=96, ppr_cap=160)
MODES = {"all": (1e-3, 1e-3), "1-hop": (1e-3, 1), "cn": (1, 1)}


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


@pytest.mark.parametrize("mode", ["all", "1-hop", "cn"])
def test_derive_budgets_identical(both, mode):
    jd, td = both
    t1, tn = MODES[mode]
    want = jbudgets.derive_budgets(jd, 0.0, t1, tn, sample=512,
                                   include_combined=True)
    got = tbudgets.derive_budgets(td, 0.0, t1, tn, sample=512,
                                  include_combined=True)
    assert got == want
    assert tbudgets.derive_budgets(td, 0.0, t1, tn, sample=512) == want[:3]
    if mode == "all":   # the probe measured counts above the 32 floor
        assert max(got) > 32


def test_rec_identical():
    rng = np.random.default_rng(0)
    for p, lo, hi in zip(rng.random(50) * 400, rng.integers(1, 64, 50),
                         rng.integers(32, 300, 50)):
        assert tbudgets._rec(p, int(lo), int(hi)) == jbudgets._rec(
            p, int(lo), int(hi))
