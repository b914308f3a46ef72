"""The port imports torch, never jax and nothing of the JAX package."""

import pathlib
import subprocess
import sys

import pytest

MODULES = [
    "genome_cycle_tpu_torch",
    "genome_cycle_tpu_torch.cli",
    "genome_cycle_tpu_torch.convert",
    "genome_cycle_tpu_torch.models.anatelophase",
    "genome_cycle_tpu_torch.models.interphase",
    "genome_cycle_tpu_torch.models.prometaphase",
    "genome_cycle_tpu_torch.models.transitions",
    "genome_cycle_tpu_torch.ops.bonded",
    "genome_cycle_tpu_torch.ops.pair_kernels",
    # The scripts at the root that run the port on a card.
    "chip_smoke",
    "profile_torch_step",
    "tune_pair_kernel",
]
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax(module):
    code = (
        f"import sys, {module}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'genome_cycle_tpu'"
        " or m.startswith('genome_cycle_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'h5py' not in sys.modules, 'h5py imported at module import'\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT
    )
    assert proc.returncode == 0, proc.stderr


def test_cli_refuses_unported_commands_and_default_device(tmp_path):
    code = (
        "import sys\n"
        "from genome_cycle_tpu_torch import cli, default_device\n"
        "assert cli.main(['ensemble', '-o', 'x_', 'c.json', 'c.tsv']) != 0\n"
        "assert cli.main(['cool', 'x.h5']) != 0\n"
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        default_device()\n"
        "    except RuntimeError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit('default_device() did not raise without a card')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("command", [
    ["anatelophase"], ["prometaphase"], ["interphase"], ["simulate"], ["cycles"],
    ["transition", "interphase"], ["transition", "prometaphase"], ["transition", "cycle"],
])
def test_cli_offers_the_stage_commands(command, capsys):
    from genome_cycle_tpu_torch import cli

    with pytest.raises(SystemExit) as exit_info:
        cli.main([*command, "--help"])
    assert exit_info.value.code == 0
    usage = capsys.readouterr().out
    takes_device = command[0] != "transition"
    assert ("--device" in usage) == takes_device


def test_cli_parses_the_composed_commands():
    """``simulate`` and ``cycles`` take the JAX CLI's arguments plus --device;
    a wrong one is refused by the parser, before anything runs."""
    from genome_cycle_tpu_torch import cli

    for argv in (["simulate", "-o", "x.h5", "config.json"],
                 ["cycles", "-n", "two", "-o", "x_", "config.json", "chains.tsv"],
                 ["transition", "cycle", "prev.h5"],
                 ["transition", "metaphase", "x.h5"]):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(argv)
        assert exit_info.value.code == 2
    assert set(cli.NOT_PORTED) == {
        "ensemble", "nci", "annotate", "cool", "dephase", "pc1", "dumpgsd", "analysis-help",
    }
