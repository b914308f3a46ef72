"""The port imports torch, never jax and nothing of the JAX package; and its
CLI offers every command of the JAX package's."""

import json
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
    "genome_cycle_tpu_torch.parallel.ensemble",
    "genome_cycle_tpu_torch.parallel.mesh",
    "genome_cycle_tpu_torch.parallel.halo",
    "genome_cycle_tpu_torch.parallel.sharded",
    "genome_cycle_tpu_torch.parallel.ranks",
    "genome_cycle_tpu_torch.analysis.common",
    "genome_cycle_tpu_torch.analysis.coolio",
    "genome_cycle_tpu_torch.analysis.cool",
    "genome_cycle_tpu_torch.analysis.dephase",
    "genome_cycle_tpu_torch.analysis.pc1",
    "genome_cycle_tpu_torch.analysis.nci",
    "genome_cycle_tpu_torch.analysis.cyto",
    "genome_cycle_tpu_torch.analysis.annotate",
    "genome_cycle_tpu_torch.analysis.gsdio",
    "genome_cycle_tpu_torch.analysis.dumpgsd",
    # The scripts at the root that run the port on a card.
    "chip_smoke",
    "profile_torch_step",
    "tune_pair_kernel",
]
ROOT = pathlib.Path(__file__).resolve().parent.parent

# Prints, after each module named on the command line is imported, which
# forbidden modules are loaded; stops at the first import that fails.
_CHECK = """
import importlib, json, sys

def forbidden():
    bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
                 or m == 'jaxlib' or m == 'genome_cycle_tpu'
                 or m.startswith('genome_cycle_tpu.'))
    bad += [m for m in ('h5py', 'triton') if m in sys.modules]
    return bad

for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
    except BaseException as err:
        print(json.dumps([name, repr(err)]), flush=True)
        break
    print(json.dumps([name, forbidden()]), flush=True)
"""


def _imports(modules):
    """{module: [] if clean, else what went wrong} for the modules imported
    in turn into one fresh interpreter, up to the first that is not clean."""
    proc = subprocess.run([sys.executable, "-c", _CHECK, *modules],
                          capture_output=True, text=True, cwd=ROOT)
    verdicts = dict(json.loads(line) for line in proc.stdout.splitlines() if line.startswith("["))
    if len(verdicts) < len(modules) and all(v == [] for v in verdicts.values()):
        verdicts[modules[len(verdicts)]] = proc.stderr[-2000:]
    return verdicts


@pytest.fixture(scope="module")
def shared_imports():
    """One interpreter imports every module in turn.  A module whose import
    leaves nothing forbidden loaded would leave nothing forbidden when
    imported alone (what it pulls in is a subset of what is loaded), so its
    case is settled here; from the first module after which something
    forbidden is loaded, each case imports its module in a fresh interpreter
    of its own."""
    verdicts = _imports(MODULES)
    return {name: True for name, bad in verdicts.items() if bad == []}


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax(module, shared_imports):
    if shared_imports.get(module):
        return
    bad = _imports([module]).get(module, "no verdict")
    assert bad == [], f"{module}: {bad}"


def test_analysis_commands_dispatch_and_default_device(tmp_path):
    """Every analysis command reaches its tool: ``--help`` of each exits 0
    and names its flags; ``cool``, ``dephase`` and ``pc1`` offer --device
    and, without a card and without ``--device cpu``, raise before they
    write anything; ``analysis-help`` lists the tools."""
    code = (
        "import contextlib, io, sys\n"
        "import torch\n"
        "from genome_cycle_tpu_torch import cli, default_device\n"
        "flags = {'nci': '--binsize', 'annotate': '--tristate', 'cool': '--frames',\n"
        "         'dephase': '--no-balancing', 'pc1': '--svd-tolerance',\n"
        "         'dumpgsd': '--stage'}\n"
        "for name, flag in flags.items():\n"
        "    out = io.StringIO()\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        try:\n"
        "            cli.main([name, '--help'])\n"
        "        except SystemExit as exit_info:\n"
        "            assert exit_info.code == 0, (name, exit_info.code)\n"
        "    usage = out.getvalue()\n"
        "    assert flag in usage, (name, usage)\n"
        "    assert ('--device' in usage) == (name in ('cool', 'dephase', 'pc1')), name\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    assert cli.main(['analysis-help']) == 0\n"
        "assert all(name in out.getvalue() for name in flags), out.getvalue()\n"
        "if not torch.cuda.is_available():\n"
        "    for argv in (['cool', '--output', 'x.cool', 'missing.h5'],\n"
        "                 ['dephase', '--output', 'y.cool', 'x.cool'],\n"
        "                 ['pc1', '--output', 'p.tsv', 'x.cool']):\n"
        "        try:\n"
        "            cli.main(argv)\n"
        "        except RuntimeError as err:\n"
        "            assert 'no CUDA device' in str(err), err\n"
        "        else:\n"
        "            raise SystemExit(f'{argv[0]} ran without a card')\n"
        "    try:\n"
        "        default_device()\n"
        "    except RuntimeError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit('default_device() did not raise without a card')\n"
        "import os\n"
        "assert not any(os.path.exists(p) for p in ('x.cool', 'y.cool', 'p.tsv'))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, env={**__import__("os").environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("command", [
    ["anatelophase"], ["prometaphase"], ["interphase"], ["simulate"], ["cycles"], ["ensemble"],
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
    assert ("--profile" in usage) == (command == ["interphase"])
    assert ("--shards" in usage) == (command == ["interphase"])


def test_cli_parses_the_composed_commands():
    """``simulate``, ``cycles`` and ``ensemble`` take the JAX CLI's arguments plus --device;
    a wrong one is refused by the parser, before anything runs."""
    from genome_cycle_tpu_torch import cli

    for argv in (["simulate", "-o", "x.h5", "config.json"],
                 ["cycles", "-n", "two", "-o", "x_", "config.json", "chains.tsv"],
                 ["ensemble", "-n", "4", "config.json", "chains.tsv"],
                 ["transition", "cycle", "prev.h5"],
                 ["transition", "metaphase", "x.h5"]):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(argv)
        assert exit_info.value.code == 2
    assert not hasattr(cli, "NOT_PORTED")
    assert set(cli.ANALYSIS_COMMANDS) == {"nci", "annotate", "cool", "dephase", "pc1", "dumpgsd"}
    assert all(module.startswith("genome_cycle_tpu_torch.analysis.")
               for module in cli.ANALYSIS_COMMANDS.values())


def test_spawned_ranks_load_no_jax(tmp_path):
    """A rank that ``parallel/mesh.spawn`` starts from this process, which
    has JAX loaded, imports the port alone: the spawn start method begins a
    fresh interpreter and the rank's function lives in the package."""
    import jax  # noqa: F401  (loaded here, to show that it does not follow)

    from genome_cycle_tpu_torch.parallel import mesh

    reports = mesh.spawn(mesh.mesh_report, 2, ["cpu", "cpu"], None, 1, 2,
                         rendezvous=tmp_path, threads=1)
    assert [r["jax_loaded"] for r in reports] == [False, False]
    assert [r["backend"] for r in reports] == ["gloo", "gloo"]
