"""The port's CLI against lpformer_tpu's: the parsed flags of every
``configs/*.json`` (with overrides, unknown keys and missing configs),
``build_config``'s fields and measured budgets, the flags the port
refuses before reading data, a train-then-``--checkpoint`` run of the
port's own, the dense attention route (``--no-pallas-attention``,
``--num-heads 2``) with ``--dump-att``, and a checkpoint the JAX CLI
trained evaluated by both CLIs."""
import ast
import dataclasses
import glob
import json
import os
import re

import numpy as np
import pytest

from lpformer_tpu.cli import run as jrun
from lpformer_tpu_torch.cli import run as trun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.splitext(os.path.basename(f))[0]
                 for f in glob.glob(os.path.join(ROOT, "configs", "*.json")))


def _parse(mod, argv):
    return vars(mod.apply_config(mod.build_parser(), argv))


def test_parser_dests_and_defaults_match():
    assert _parse(trun, []) == _parse(jrun, [])


@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_parses_as_jax(name):
    for extra in ([], ["--batch-size", "512", "--platform", "cpu",
                       "--eps", "1e-3", "--heart"]):
        argv = ["--config", name] + extra
        assert _parse(trun, argv) == _parse(jrun, argv), argv


def test_config_errors_match(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"dim": 48, "not_a_flag": 1}))
    for mod in (jrun, trun):
        with pytest.raises(ValueError, match="unknown config keys"):
            _parse(mod, ["--config", str(bad)])
        with pytest.raises(FileNotFoundError):
            _parse(mod, ["--config", "no-such-config"])
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"dim": 48, "mask_input": True}))
    assert _parse(trun, ["--config", str(good)]) == _parse(
        jrun, ["--config", str(good)])


SYN = ["--data_name", "synthetic", "--syn-nodes", "120", "--syn-edges",
       "400", "--syn-feat", "8", "--dim", "16", "--eps", "1e-3"]


@pytest.mark.parametrize("combined", [None, "auto", "48"])
def test_build_config_matches(combined):
    argv = SYN + ([] if combined is None else ["--budget-combined", combined])
    jargs, targs = (m.apply_config(m.build_parser(), argv)
                    for m in (jrun, trun))
    jcfg = jrun.build_config(jargs, jrun.load_dataset(jargs))
    tcfg = trun.build_config(targs, trun.load_dataset(targs, "cpu"))
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert set(t) == set(j)
    assert t == j
    if combined == "48":
        assert tcfg.budget_combined == 48
    else:
        assert (tcfg.budget_combined is None) == (combined is None)


@pytest.fixture
def restore_torch_flags():
    import torch

    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    yield
    torch.use_deterministic_algorithms(det, warn_only=warn)


@pytest.mark.parametrize("flag,exc", [
    # a CUDA mesh needs a GPU per rank; these tests run without one
    (["--mesh", "2,2"], RuntimeError),
    (["--mesh", "2,2", "--context-parallel"], RuntimeError),
    # partial multi-process flags, and 'auto' outside torchrun
    (["--coordinator", "localhost:1234"], ValueError),
    (["--num-processes", "2"], ValueError),
    (["--distributed", "auto"], ValueError),
    (["--process-id", "1"], ValueError),
    (["--platform", "tpu"], ValueError),
])
def test_refused_flags_raise_before_reading_data(tmp_path, flag, exc,
                                                  restore_torch_flags,
                                                  monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LPFORMER_COORDINATOR", "LPFORMER_NUM_PROCESSES",
              "LPFORMER_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    # reading this dataset would raise FileNotFoundError
    argv = ["--data_name", "cora", "--data-dir", str(tmp_path / "none")]
    with pytest.raises(FileNotFoundError):
        trun.main(argv + ["--platform", "cpu"])
    with pytest.raises(exc):
        trun.main(argv + flag)


def test_platform_names():
    assert [trun.resolve_platform(p) for p in (None, "cpu", "gpu", "cuda")] \
        == [None, "cpu", "cuda", "cuda"]


BASE = ["--data_name", "synthetic", "--platform", "cpu", "--jax-cache-dir",
        "", "--syn-nodes", "120", "--syn-edges", "400", "--dim", "16",
        "--batch-size", "128", "--test-batch-size", "64", "--eval_steps",
        "1", "--epochs", "1", "--budget-cn", "16", "--budget-onehop", "32",
        "--budget-non1hop", "32", "--dropout", "0", "--gnn-drop", "0",
        "--att-drop", "0", "--pred-drop", "0"]


def _printed_metrics(text):
    """{metric: (train, valid, test)} from the '  name = (...)' lines."""
    return {m.group(1): ast.literal_eval(m.group(2)) for m in re.finditer(
        r"^  (\S+) = (\(.*\))$", text, re.M)}


def test_port_cli_trains_then_evaluates_its_checkpoint(
        tmp_path, monkeypatch, capsys, restore_torch_flags):
    monkeypatch.chdir(tmp_path)  # the PPR cache of a reader lands here
    argv = BASE + ["--checkpoint-dir", str(tmp_path / "ck")]
    trun.main(argv + ["--save-as", "m"])
    trained = _printed_metrics(capsys.readouterr().out)
    assert list(trained) == ["MRR"]
    assert os.path.isfile(tmp_path / "ck" / "synthetic" / "m.ckpt")
    res = trun.main(argv + ["--checkpoint", "m"])
    evaluated = _printed_metrics(capsys.readouterr().out)
    assert sorted(evaluated) == ["Hits@100", "Hits@20", "Hits@50", "MRR"]
    # the best epoch's numbers, bit for bit
    assert evaluated["MRR"] == trained["MRR"]
    assert res == [trained["MRR"][2]]


@pytest.mark.parametrize("route", [["--no-pallas-attention"],
                                   ["--num-heads", "2"]])
def test_dense_route_trains_and_dumps_attention(
        tmp_path, monkeypatch, capsys, restore_torch_flags, route):
    """--no-pallas-attention (one head) and --num-heads 2 train through the
    dense route alone (the fused op never runs), and --dump-att with
    --save-as writes attention_weights.npz in the working directory: the
    first --test-batch-size test positives, their context ids and
    validity, and alpha [B, C], 0 on invalid slots and summing to 1 over
    each link's valid ones."""
    from lpformer_tpu_torch.models import link_transformer as tlt

    monkeypatch.chdir(tmp_path)
    fused = []
    for name in ("fused_pe_link_attention", "fused_pe_link_attention_mixed"):
        real = getattr(tlt, name)
        monkeypatch.setattr(tlt, name, lambda *a, _r=real, **k: (
            fused.append(1), _r(*a, **k))[1])
    argv = SYN + route + [
        "--platform", "cpu", "--epochs", "1", "--eval_steps", "1",
        "--batch-size", "128", "--test-batch-size", "16", "--dump-att",
        "--save-as", "m", "--checkpoint-dir", str(tmp_path / "ck")]
    trun.main(argv)
    out = capsys.readouterr().out
    assert "--dump-att: wrote attention_weights.npz for 16 edges" in out
    assert not fused
    args = trun.apply_config(trun.build_parser(), argv)
    ds = trun.load_dataset(args, "cpu")
    c = trun.build_config(args, ds).context.total_budget
    with np.load(tmp_path / "attention_weights.npz") as z:
        assert sorted(z.files) == ["alpha", "edges", "ids", "valid"]
        np.testing.assert_array_equal(z["edges"], ds.test_pos[:16])
        assert z["ids"].shape == z["valid"].shape == z["alpha"].shape == (
            16, c)
        valid, alpha = z["valid"], z["alpha"]
    assert valid.any() and (alpha[~valid] == 0).all()
    has = valid.any(1)
    np.testing.assert_allclose(alpha[has].sum(1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """One tiny synthetic model trained by the JAX CLI (one epoch,
    dropouts 0), saved with --save-as."""
    import torch

    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    root = tmp_path_factory.mktemp("jax_cli")
    argv = BASE + ["--checkpoint-dir", str(root / "ck")]
    jrun.main(argv + ["--save-as", "j"])
    torch.use_deterministic_algorithms(det, warn_only=warn)
    return argv


def test_jax_checkpoint_evaluates_alike_in_both_clis(
        jax_checkpoint, capsys, restore_torch_flags):
    capsys.readouterr()
    jres = jrun.main(jax_checkpoint + ["--checkpoint", "j"])
    jm = _printed_metrics(capsys.readouterr().out)
    tres = trun.main(jax_checkpoint + ["--checkpoint", "j"])
    tm = _printed_metrics(capsys.readouterr().out)
    assert sorted(tm) == sorted(jm) == ["Hits@100", "Hits@20", "Hits@50",
                                        "MRR"]
    # one rank position among the eval set's negatives
    tol = 1.0 / max(400 // 20, 10)
    gap = max(abs(a - b) for k in jm for a, b in zip(tm[k], jm[k]))
    assert gap <= tol, (gap, tm, jm)
    np.testing.assert_allclose(tres, jres, rtol=0, atol=tol)


def test_graft_entry_matches_jax_forward():
    """graft_entry.entry's forward and scores on the CPU against the JAX
    package's at the same tiny shapes and weights (__graft_entry__.py:
    _tiny_setup, entry), in f32 to tests/test_torch_model.py's
    tolerance."""
    import jax
    import torch

    from lpformer_tpu.data.synthetic import synthetic_dataset
    from lpformer_tpu.models import LPFormerConfig, forward, init_lpformer
    from lpformer_tpu.models import score_links
    from lpformer_tpu_torch import graft_entry
    from lpformer_tpu_torch.utils.params import from_jax_params

    fn, (params, graph, src, tgt) = graft_entry.entry(device="cpu")
    ds = synthetic_dataset(seed=0, num_nodes=256, num_train=900,
                           num_eval=64, feat_dim=32, eps=1e-3)
    cfg = LPFormerConfig(dim=32, gnn_layers=2, budget_cn=32,
                         budget_onehop=64, budget_non1hop=64)
    jparams = init_lpformer(jax.random.PRNGKey(0), cfg, in_dim=32)
    jsrc, jtgt = ds.train_pos[:64, 0], ds.train_pos[:64, 1]
    np.testing.assert_array_equal(src.numpy(), jsrc)
    np.testing.assert_array_equal(tgt.numpy(), jtgt)
    want = np.asarray(score_links(jparams, cfg, forward(
        jparams, cfg, ds.graph, jsrc, jtgt, train=False), train=False))
    got = fn(from_jax_params(jax.tree.map(np.asarray, jparams),
                             device="cpu"), graph, src, tgt)
    assert got.shape == (64,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-5)
    assert fn(params, graph, src, tgt).shape == (64,)
