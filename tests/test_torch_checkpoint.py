"""Checkpoints across the two packages: a file the port writes loads in
lpformer_tpu's ``load_checkpoint(target=...)`` and one JAX writes loads in
the port's, every leaf bit for bit (a bfloat16 leaf through the
manifest's dtype entry); the atomic write, the pickle refusal and the
target validation; and train_loop's ``save_as`` / ``save_every`` paths
(named as the JAX trainer names them) and ``resume``.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lpformer_tpu.models import LPFormerConfig as JConfig
from lpformer_tpu.models import link_transformer as jlt
from lpformer_tpu.train import optim as joptim
from lpformer_tpu.utils import checkpoint as jckpt
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models.config import LPFormerConfig as TConfig
from lpformer_tpu_torch.train import optim as toptim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.train import trainer as ttrainer
from lpformer_tpu_torch.utils import checkpoint as tckpt
from lpformer_tpu_torch.utils.params import from_jax_opt_state, from_jax_params

COMMON = dict(dim=8, gnn_layers=2, budget_cn=8, budget_onehop=16,
              budget_non1hop=16)
KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)


def _jax_state(seed=3):
    """A JAX training state after one optimizer update (nonzero moments)
    with the GCN's first weight in bfloat16."""
    cfg = JConfig(**COMMON)
    params = jlt.init_lpformer(jax.random.PRNGKey(seed), cfg, in_dim=12)
    opt = joptim.make_optimizer(1e-2, steps_per_epoch=1)
    grads = jax.tree.map(lambda x: jnp.ones_like(x) * 0.1, params)
    upd, ost = opt.update(grads, opt.init(params), params)
    params = jax.tree.map(jnp.add, params, upd)
    params["node_encoder"]["convs"][0]["w"] = (
        params["node_encoder"]["convs"][0]["w"].astype(jnp.bfloat16))
    return {"params": params, "opt_state": ost,
            "step": jnp.asarray(7, jnp.int32), "epoch": 4, "seed": 2}


def _jax_skeleton():
    st = _jax_state(0)
    return {"params": st["params"], "opt_state": st["opt_state"],
            "step": jnp.asarray(0, jnp.int32), "epoch": 0, "seed": 0}


def _port_skeleton():
    st = _jax_state(0)
    return {"params": from_jax_params(jax.tree.map(
                lambda a: np.asarray(a, np.float32), st["params"]),
                device="cpu"),
            "opt_state": from_jax_opt_state(
                jax.tree.map(np.asarray, st["opt_state"]), device="cpu"),
            "step": torch.zeros((), dtype=torch.int32), "epoch": 0,
            "seed": 0}


def _pairs(jtree, ttree):
    j = jax.tree_util.tree_leaves_with_path(jtree)
    t = toptim.tree_leaves_with_path(ttree)
    assert len(j) == len(t)
    return [(jax.tree_util.keystr(p), np.asarray(a), b)
            for (p, a), (_, b) in zip(j, t)]


def _port_state():
    """The JAX state of _jax_state as the port holds it: tensors (the
    bf16 leaf a torch.bfloat16 tensor), the step a 0-d int32."""
    st = jax.tree.map(np.asarray, _jax_state())
    params = from_jax_params(
        jax.tree.map(lambda a: a.astype(np.float32), st["params"]),
        device="cpu")
    params["node_encoder"]["convs"][0]["w"] = (
        params["node_encoder"]["convs"][0]["w"].to(torch.bfloat16))
    return {"params": params,
            "opt_state": from_jax_opt_state(st["opt_state"], device="cpu"),
            "step": np.asarray(7, np.int32), "epoch": 4, "seed": 2}


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.ckpt")
    tckpt.save_checkpoint(path, _port_state())
    assert os.listdir(tmp_path) == ["port.ckpt"]   # no temporary file left
    got = jckpt.load_checkpoint(path, target=_jax_skeleton())
    want = jax.tree.map(np.asarray, _jax_state())
    for (name, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(want)):
        assert np.asarray(a).dtype == b.dtype, name
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(name))
    assert got["params"]["node_encoder"]["convs"][0]["w"].dtype == \
        ml_dtypes.bfloat16
    assert int(got["step"]) == 7 and np.asarray(got["step"]).dtype == np.int32
    # the JAX package's own generic load sees the same tree
    generic = jckpt.load_checkpoint(path)
    assert sorted(generic) == ["epoch", "opt_state", "params", "seed", "step"]


def test_jax_checkpoint_loads_in_port(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, _jax_state())
    got = tckpt.load_checkpoint(path, target=_port_skeleton())
    want = jax.tree.map(np.asarray, _jax_state())
    for name, w, g in _pairs(want, got):
        assert isinstance(g, torch.Tensor), name
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32), err_msg=name)
        else:
            assert g.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # without a target: nested dicts and lists, the same leaves
    generic = tckpt.load_checkpoint(path)
    assert isinstance(generic["params"]["att_layers"], list)
    assert torch.equal(generic["opt_state"]["m"], got["opt_state"]["m"])
    # and the port's own round trip
    again = str(tmp_path / "again.ckpt")
    tckpt.save_checkpoint(again, got)
    back = tckpt.load_checkpoint(again, target=_port_skeleton())
    for (_, a), (_, b) in zip(toptim.tree_leaves_with_path(back),
                              toptim.tree_leaves_with_path(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_refuses_pickle_and_mismatched_targets(tmp_path):
    assert tckpt.load_checkpoint(str(tmp_path / "absent.ckpt")) is None
    bad = tmp_path / "legacy.ckpt"
    bad.write_bytes(pickle.dumps({"leaves": [1, 2]}, protocol=2))
    with pytest.raises(ValueError, match="pickle"):
        tckpt.load_checkpoint(str(bad))
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(str(junk))
    path = str(tmp_path / "small.ckpt")
    tckpt.save_checkpoint(path, {"a": torch.ones(2), "b": [torch.zeros(1)]})
    for target in ({"a": torch.ones(2)},                        # extra in file
                   {"a": torch.ones(2), "b": [torch.zeros(1)],
                    "c": torch.zeros(1)}):                      # missing
        with pytest.raises(ValueError, match="target structure"):
            tckpt.load_checkpoint(path, target=target)


def test_train_loop_checkpoints_and_resume(tmp_path, monkeypatch):
    """train_data with ``save_as`` and two runs writes the JAX trainer's
    paths; a resume from ``<name>.latest.ckpt`` starts at its epoch + 1
    with the saved state (and the JAX trainer's skeleton loads the
    port's file)."""
    td = synthetic_dataset(**KW, device="cpu")
    cfg = TConfig(**COMMON)
    args = ttrainer.TrainArgs(epochs=1, batch_size=128, test_batch_size=64,
                              eval_steps=1, save_every=1, runs=2,
                              save_as="run", data_name="tiny",
                              checkpoint_dir=str(tmp_path), verbose=False)
    ttrainer.train_data(args, cfg, td)
    folder = tmp_path / "tiny"
    names = sorted(os.listdir(folder))
    assert names == ["run_seed-1.ckpt", "run_seed-1.latest.ckpt",
                     "run_seed-2.ckpt", "run_seed-2.latest.ckpt"]
    latest = str(folder / "run_seed-1.latest.ckpt")
    saved = tckpt.load_checkpoint(latest)
    steps = -(-len(td.train_pos) // 128)
    assert int(saved["epoch"]) == 1 and int(saved["seed"]) == 0
    assert int(saved["step"]) == steps
    assert saved["step"].dtype == torch.int32
    jparams = jlt.init_lpformer(jax.random.PRNGKey(0), JConfig(**COMMON),
                                in_dim=12)
    from_jax = jckpt.load_checkpoint(latest, target={
        "params": jparams, "opt_state": joptim.make_optimizer(1e-3).init(
            jparams), "step": jnp.asarray(0, jnp.int32), "epoch": 0,
        "seed": 0})
    np.testing.assert_array_equal(np.asarray(from_jax["opt_state"]["m"]),
                                  saved["opt_state"]["m"].numpy())

    seen = {}
    real = tstep.make_train_step

    def spy(*a, **k):
        step = real(*a, **k)

        def first(state, *rest):
            seen.setdefault("state", (
                [x.detach().clone() for x in toptim.tree_leaves(state.params)],
                {k: v.clone() for k, v in state.opt_state.items()},
                state.step))
            return step(state, *rest)
        return first

    monkeypatch.setattr(tstep, "make_train_step", spy)
    resumed = ttrainer.TrainArgs(epochs=2, batch_size=128, test_batch_size=64,
                                 eval_steps=1, resume=latest, verbose=False)
    losses = []
    loggers = {k: ttrainer.ResultsLogger(1) for k in
               ("Hits@20", "Hits@50", "Hits@100", "MRR")}
    ttrainer.train_loop(resumed, cfg, td, loggers, 0, step_losses=losses)
    assert len(losses) == steps                 # epoch 2 alone ran
    assert len(loggers["MRR"].results[0]) == 1
    params, opt_state, step = seen["state"]
    assert step == steps
    for a, b in zip(params, toptim.tree_leaves(saved["params"])):
        assert torch.equal(a, b)
    for k in ("count", "m", "v", "score_mask"):
        assert torch.equal(opt_state[k], saved["opt_state"][k]), k
    with pytest.raises(FileNotFoundError):
        ttrainer.train_loop(
            ttrainer.TrainArgs(epochs=1, resume=str(tmp_path / "none"),
                               verbose=False), cfg, td, {}, 0)
