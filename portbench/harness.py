"""What every part of the benchmark shares: where things are, and how a
configuration, a cell, a driver and a per-layer metric are found by name.

Everything that belongs to one configuration, one cell (a traffic mix on a
configuration), one driver or one per-layer metric lives in a file of its
own, found by the name ``BENCHMARK.json`` gives it:

    configs/<config>.json      the deployment: grid, physics, solver, slots
    workloads/<cell>.json      the cell: configuration, driver, traffic, limits
    drivers/<kind>.py          a driver: ``run(cell) -> dict``
    metrics/<metric>.py        a metric: ``read(record) -> float | None``
    reference/<name>.py        the plain reference a configuration names

Adding a configuration, a cell or a metric adds files; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"

# Top-level module names that may never be loaded by a run: the JAX stack
# and the JAX package the port was made from.  Compared whole: the port's
# own name begins with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config(name: str, root: Path = HERE) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def workload(name: str, root: Path = HERE) -> dict:
    return load_json(root / "workloads" / f"{name}.json")


def module(kind: str, name: str, root: Path = HERE):
    """The module ``<root>/<kind>/<name>.py``, loaded by its path (a metric's
    name may hold dots)."""
    path = root / kind / f"{name}.py"
    key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def use_program():
    """Make the port importable from the checkout's ``src``."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules this process holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def seed_ints(seed: int, *extra: int) -> list[int]:
    """Non-negative words for ``numpy.random.SeedSequence`` from any whole
    number, however large or negative."""
    words, s = [], abs(int(seed))
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return [int(seed < 0), *words, *extra]
