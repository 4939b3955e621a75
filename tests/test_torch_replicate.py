"""The port's replicate scripts (scripts/replicate_{existing,heart}_torch.sh)
against the JAX package's (scripts/replicate_{existing,heart}.sh): each
line is the JAX line with the CLI module's name changed and nothing else,
and each command's flags parse through both CLIs' parsers, with no data
read, to the same namespace."""
import os
import shlex

import pytest

from lpformer_tpu.cli import run as jrun
from lpformer_tpu_torch.cli import run as trun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("existing", "heart")
JAX_CLI, PORT_CLI = "lpformer_tpu.cli.run", "lpformer_tpu_torch.cli.run"


def _lines(name):
    with open(os.path.join(ROOT, "scripts", f"{name}.sh")) as f:
        return f.read().splitlines()


def _commands(script):
    """(data_name, the port's argv after the module) of each command line
    of the port's script."""
    out = []
    for line in _lines(f"replicate_{script}_torch"):
        if line.startswith("python "):
            argv = shlex.split(line)
            assert argv[:3] == ["python", "-m", PORT_CLI], line
            out.append((argv[argv.index("--data_name") + 1], argv[3:]))
    return out


COMMANDS = [(script, name, argv) for script in SCRIPTS
            for name, argv in _commands(script)]


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_is_the_jax_script_with_the_port_cli(script):
    jax_lines = _lines(f"replicate_{script}")
    port_lines = _lines(f"replicate_{script}_torch")
    assert len(port_lines) == len(jax_lines)
    for j, t in zip(jax_lines, port_lines):
        assert t == j.replace(JAX_CLI, PORT_CLI), t
    commands = [t for t in port_lines if PORT_CLI in t]
    assert commands and all(t.startswith(f"python -m {PORT_CLI} ")
                            for t in commands)
    assert not any(JAX_CLI in t for t in port_lines)


def test_scripts_hold_every_command():
    """13 commands: six of the existing setting, seven of HeaRT."""
    assert [len(_commands(s)) for s in SCRIPTS] == [6, 7]


@pytest.mark.parametrize(
    "script,name,argv", COMMANDS,
    ids=[f"{script}-{name}" for script, name, _ in COMMANDS])
def test_command_parses_as_jax(script, name, argv):
    """The port's parser gives the JAX parser's namespace for the line's
    flags (dests only the port has excluded by name)."""
    t = vars(trun.apply_config(trun.build_parser(), argv))
    j = vars(jrun.apply_config(jrun.build_parser(), argv))
    port_only = set(t) - set(j)
    assert set(j) <= set(t)
    assert {k: v for k, v in t.items() if k not in port_only} == j
    assert t["data_name"] == name
    assert t["heart"] == (script == "heart")
