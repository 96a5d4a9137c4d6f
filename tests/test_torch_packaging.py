"""Packaging of the port: its console script, its type marker, and the
production-flow example's freedom from JAX. On the CPU, in process (the
``--help`` run) or in one fresh interpreter (the import check).

The JAX package's own script line stays as ``tests/test_packaging.py``
asserts it; the port's resolves to ``lithographysimulator_tpu_torch.cli``.
"""

import contextlib
import importlib
import io
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT_SCRIPT = "lithographysimulator-tpu-torch"
SUBCOMMANDS = ("simulate", "demo", "socs", "m3dcal", "focus", "resist3d",
               "stochastic", "calibrate", "fem", "smo", "opc", "fitaberr",
               "lele")


def _pyproject() -> dict:
    return tomllib.loads((REPO / "pyproject.toml").read_text())


def _resolve(entry: str):
    module, _, attr = entry.partition(":")
    return getattr(importlib.import_module(module), attr)


def test_console_scripts_resolve():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts[PORT_SCRIPT] == "lithographysimulator_tpu_torch.cli:main"
    assert scripts["lithographysimulator-tpu"] == "lithographysimulator_tpu.cli:main"
    from lithographysimulator_tpu_torch import cli

    assert _resolve(scripts[PORT_SCRIPT]) is cli.main


def _help(main) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
        main(["--help"])
    assert exit_.value.code == 0
    return out.getvalue()


def _subcommands(help_text: str) -> list:
    return re.search(r"\{([a-z0-9,]+)\}", help_text).group(1).split(",")


def test_port_help_lists_every_subcommand_of_the_jax_cli():
    from lithographysimulator_tpu import cli as jcli
    from lithographysimulator_tpu_torch import cli

    ours = _subcommands(_help(cli.main))
    assert sorted(ours) == sorted(SUBCOMMANDS) and len(ours) == 13
    assert sorted(ours) == sorted(_subcommands(_help(jcli.main)))


def test_py_typed_ships_with_the_port():
    assert (REPO / "lithographysimulator_tpu_torch" / "py.typed").is_file()
    data = _pyproject()["tool"]["setuptools"]["package-data"]
    assert "py.typed" in data["lithographysimulator_tpu_torch"]
    assert data["lithographysimulator_tpu"] == ["py.typed"]


def test_production_flow_example_imports_no_jax():
    """The example and the port it imports load neither jax nor the JAX
    package."""
    code = ("import importlib.util, sys; "
            "spec = importlib.util.spec_from_file_location('flow', "
            "'examples/production_flow_torch.py'); "
            "mod = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(mod); "
            "assert callable(mod.run_flow) and callable(mod.main); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lithographysimulator_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"
