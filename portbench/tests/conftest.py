"""The benchmark's own tests: ``python -m pytest -q portbench/tests``.

They import the harness's modules by their plain names, as ``run.py`` does,
and the port from the checkout's ``src``.  Tests that need the card carry
the ``cuda`` marker and decide inside the test whether there is one.
"""
import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def small(name: str, n: int = 16, slots: int = 4):
    """A cell's files cut to a grid a CPU test holds: ``n``^3 on the
    program's plain backend, ``slots`` slots."""
    import harness

    wl = copy.deepcopy(harness.workload(name))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg["grid"] = [n, n, n]
    cfg["backend"] = "torch"
    if "n_slots" in cfg:
        cfg["n_slots"] = slots
    return wl, cfg


@pytest.fixture
def cell_files():
    return small
