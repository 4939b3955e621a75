"""The port's utils against lpformer_tpu's: ``init_seed``'s host streams
and deterministic flag, and the reference-checkpoint import (of the state
the JAX package exports, back to the same params, and a ``.pt`` file
through ``cli/import_reference.py`` into a checkpoint both packages
load)."""
import random

import jax
import numpy as np
import pytest
import torch

from lpformer_tpu.models.config import LPFormerConfig as JConfig
from lpformer_tpu.models.link_transformer import init_lpformer
from lpformer_tpu.utils import checkpoint as jckpt
from lpformer_tpu.utils import interop as jinterop
from lpformer_tpu.utils import seed as jseed
from lpformer_tpu_torch.cli import import_reference
from lpformer_tpu_torch.train.optim import tree_leaves_with_path
from lpformer_tpu_torch.utils import checkpoint as tckpt
from lpformer_tpu_torch.utils import interop as tinterop
from lpformer_tpu_torch.utils import seed as tseed


@pytest.fixture
def restore_torch_flags():
    """init_seed sets a process-wide torch flag; put it back for the
    tests that follow in this process."""
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    yield
    torch.use_deterministic_algorithms(det, warn_only=warn)


def _draws():
    return ([random.random() for _ in range(3)], np.random.rand(3).tolist(),
            torch.rand(3).tolist())


@pytest.mark.parametrize("seed", [0, 42])
def test_init_seed_streams_match(seed, restore_torch_flags):
    jseed.init_seed(seed)
    want = _draws()
    tseed.init_seed(seed)
    got = _draws()
    assert got == want
    # on the CPU the flag is the JAX package's; a CUDA run leaves it off
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(False)
    tseed.init_seed(seed, torch.device("cuda"))
    assert _draws() == want
    assert not torch.are_deterministic_algorithms_enabled()


CFGS = [
    # (mask mode exercised, trans_layers), as tests/test_interop.py
    JConfig(dim=16, gnn_layers=3, trans_layers=1,
            thresh_1hop=1e-2, thresh_non1hop=1e-2),   # "all"
    JConfig(dim=16, gnn_layers=1, trans_layers=1,
            thresh_1hop=1e-2, thresh_non1hop=1.0),    # "1-hop"
    JConfig(dim=16, gnn_layers=2, trans_layers=2,
            thresh_1hop=1.0, thresh_non1hop=1.0),     # "cn"
]


def _jparams(cfg):
    return jax.tree.map(np.asarray, init_lpformer(jax.random.PRNGKey(0), cfg,
                                                  in_dim=24))


def _same_tree(t, j):
    tl = tree_leaves_with_path(t)
    jl = jax.tree_util.tree_leaves_with_path(j)
    assert [p for p, _ in tl] == [tuple(getattr(k, "key", getattr(
        k, "idx", None)) for k in p) for p, _ in jl]
    for (_, a), (_, b) in zip(tl, jl):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _as_torch(state):
    """A reference state dict of numpy arrays as one of torch tensors."""
    return {part: {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}
            for part, sd in state.items()}


@pytest.mark.parametrize("cfg", CFGS, ids=["all", "1hop", "cn"])
def test_interop_matches_and_round_trips(cfg):
    params = _jparams(cfg)
    jstate = jinterop.export_reference_state(params)
    # import of the same state dict, from numpy and from tensors: equal
    # to the JAX package's import, and back to the exported params
    _same_tree(tinterop.import_reference_state(jstate, device="cpu"),
               jinterop.import_reference_state(jstate))
    _same_tree(tinterop.import_reference_state(_as_torch(jstate),
                                               device="cpu"), params)


def test_pt_file_conversion_loads_in_both_packages(tmp_path):
    params = _jparams(CFGS[0])
    state = _as_torch(jinterop.export_reference_state(params))
    state["optimizer"] = {"state": {}, "param_groups": []}
    torch.save(state, tmp_path / "ref.pt")
    import_reference.main([str(tmp_path / "ref.pt"), "--data", "ogbl-collab",
                           "--out", "imp", "--outdir", str(tmp_path)])
    path = str(tmp_path / "ogbl-collab" / "imp.ckpt")
    got = tckpt.load_checkpoint(path)
    assert int(got["step"]) == 0 and int(got["epoch"]) == 0
    _same_tree(got["params"], params)
    jgot = jckpt.load_checkpoint(path)
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jgot["params"]), params)
