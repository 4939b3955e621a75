"""The port stands alone: no module of lpformer_tpu_torch, and not
chip_smoke.py, imports jax or lpformer_tpu; and its entry points run on
CUDA unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lpformer_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_source():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        bad = {"jax", "jaxlib", "lpformer_tpu"} & set(_imported_roots(path))
        assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("module", [
    "ops/pe_attention_mixed.py", "ops/pe_attention.py", "ops/scatter.py",
    "ops/attention.py", "ops/lookup.py", "ops/search.py", "ops/_cuda.py",
    "cli/run.py", "cli/import_reference.py", "data/ogb.py",
    "data/planetoid.py", "utils/seed.py", "utils/interop.py",
    "graft_entry.py",
])
def test_kernel_modules_are_covered(module):
    """Each module that holds a kernel wrapper, and the CLI, the dataset
    readers and the utils they need, is among the files checked above and
    below, and imports neither jax nor lpformer_tpu."""
    path = os.path.join(PKG, *module.split("/"))
    assert path in _port_files()
    assert not {"jax", "jaxlib", "lpformer_tpu"} & set(_imported_roots(path))


def test_importing_every_module_loads_no_jax():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'lpformer_tpu')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    from lpformer_tpu_torch import resolve_device
    from lpformer_tpu_torch.cli import run as cli_run
    from lpformer_tpu_torch.data.synthetic import synthetic_dataset
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.models.config import LPFormerConfig
    from lpformer_tpu_torch.utils.interop import import_reference_state
    from lpformer_tpu_torch.utils.params import from_jax_opt_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        lt.init_lpformer(torch.Generator().manual_seed(0),
                         LPFormerConfig(budget_combined=8), 4)
    with pytest.raises(RuntimeError, match="no GPU"):
        synthetic_dataset(num_nodes=20, num_train=40, num_eval=4)
    with pytest.raises(RuntimeError, match="no GPU"):
        # the CLI's dataset, as main() reads it without --platform
        cli_run.load_dataset(cli_run.apply_config(cli_run.build_parser(), [
            "--data_name", "synthetic", "--syn-nodes", "20",
            "--syn-edges", "40"]))
    with pytest.raises(RuntimeError, match="no GPU"):
        import_reference_state({"model": {}, "score_func": {}})
    with pytest.raises(RuntimeError, match="no GPU"):
        from_jax_opt_state({"count": 0, "m": [0.0], "v": [0.0],
                            "score_mask": [0.0]})
    assert resolve_device("cpu") == torch.device("cpu")
