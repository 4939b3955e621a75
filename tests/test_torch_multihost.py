"""The port's multi-process bring-up (lpformer_tpu_torch/parallel/
distributed.py) and the CLI's mesh flags, the counterparts of
tests/test_multihost.py.

Two ranks started with the explicit flags (tests/torch_multihost_child.py)
take two sharded steps; their losses are the same on both ranks and equal
the single-process run (a 1 x 1 mesh) at rtol 2e-5 / atol 1e-6, as in
tests/test_multihost.py. The CLI trains a tiny synthetic graph on a 2 x 2
CPU mesh (4 gloo ranks it spawns itself); rank 0 alone prints, and the
checkpoint it writes evaluates the same without and with the mesh, each
metric within 2e-3 (tests/test_parallel.py's eval tolerance).
"""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from lpformer_tpu_torch.cli import run as trun
from lpformer_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_multihost_child.py")
CLI = ["--data_name", "synthetic", "--platform", "cpu", "--syn-nodes", "120",
       "--syn-edges", "400", "--dim", "16", "--batch-size", "128",
       "--test-batch-size", "64", "--eval_steps", "1", "--epochs", "1",
       "--budget-cn", "16", "--budget-onehop", "32", "--budget-non1hop", "32",
       "--jax-cache-dir", ""]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("LPFORMER_COORDINATOR", "LPFORMER_NUM_PROCESSES",
              "LPFORMER_PROCESS_ID", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    return env


@pytest.mark.parametrize("kw", [
    dict(coordinator="localhost:9999"), dict(num_processes=2),
    dict(process_id=1), dict(coordinator="localhost:9999", num_processes=2),
])
def test_partial_flags_raise_all_three(kw):
    with pytest.raises(ValueError, match="all three"):
        distributed.initialize(**kw)


def test_env_variables_are_read(monkeypatch):
    """LPFORMER_COORDINATOR / LPFORMER_NUM_PROCESSES stand in for the
    flags: with the process id missing, the error names both."""
    monkeypatch.setenv("LPFORMER_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("LPFORMER_NUM_PROCESSES", "3")
    monkeypatch.delenv("LPFORMER_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match=r"127\.0\.0\.1:1.*num_processes=3"):
        distributed.initialize()


def test_auto_needs_torchrun_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        distributed.initialize(auto=True)


def test_no_flags_is_noop_single_process(monkeypatch):
    for k in ("LPFORMER_COORDINATOR", "LPFORMER_NUM_PROCESSES",
              "LPFORMER_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.is_coordinator()
    assert distributed.process_count() == 1


def _children(n):
    port = distributed.free_port()
    procs = [subprocess.Popen([sys.executable, CHILD, str(i), str(n),
                               str(port)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    losses = {}
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"child {i} failed:\n{out[-3000:]}"
        m = re.search(r"MULTIHOST_LOSS (\d+) (\S+) (\S+)", out)
        assert m, out[-3000:]
        losses[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    return losses


def test_two_process_step_matches_single_process():
    two = _children(2)
    assert set(two) == {0, 1}
    assert two[0] == two[1]           # replicated: the same bits
    one = _children(1)
    np.testing.assert_allclose(two[0], one[0], rtol=2e-5, atol=1e-6)


def _metrics(text):
    return {m.group(1): ast.literal_eval(m.group(2)) for m in re.finditer(
        r"^\s+(\S+) = (\(.*\))$", text, re.M)}


def _cli(argv, cwd):
    r = subprocess.run([sys.executable, "-m", "lpformer_tpu_torch.cli.run"]
                       + argv, cwd=cwd, env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_cli_mesh_trains_and_rank0_writes(tmp_path):
    """One epoch on a 2 x 2 mesh of 4 spawned gloo ranks: one rank prints
    and a checkpoint is written; it evaluates alike without and with the
    mesh."""
    ck = str(tmp_path / "ck")
    out = _cli(CLI + ["--mesh", "2,2", "--save-as", "m", "--checkpoint-dir",
                      ck], tmp_path)
    assert out.count("Epoch 1 Loss") == 1, out
    assert out.count("[data] synthetic") == 1, out
    loss = float(re.search(r"Epoch 1 Loss: (\S+)", out).group(1))
    assert np.isfinite(loss)
    assert os.listdir(os.path.join(ck, "synthetic")) == ["m.ckpt"]
    single = _metrics(_cli(CLI + ["--checkpoint", "m", "--checkpoint-dir",
                                  ck], tmp_path))
    mesh = _metrics(_cli(CLI + ["--checkpoint", "m", "--checkpoint-dir", ck,
                                "--mesh", "2,2"], tmp_path))
    assert set(single) == set(mesh) and "MRR" in single
    for k, v in single.items():
        np.testing.assert_allclose(mesh[k], v, atol=2e-3, err_msg=k)


def test_cli_grad_accum_with_mesh_raises():
    with pytest.raises(ValueError, match="grad-accum"):
        trun.main(CLI + ["--mesh", "2,2", "--grad-accum", "2"])


def test_cli_cuda_mesh_needs_one_gpu_per_rank(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    argv = [a for a in CLI if a not in ("--platform", "cpu")]
    with pytest.raises(RuntimeError, match="needs 4 GPUs"):
        trun.main(argv + ["--mesh", "2,2"])
