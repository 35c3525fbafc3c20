"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
examples' twins (``examples/*_torch.py``) import neither ``jax`` nor the
reference package ``repro``, and import nothing heavy (no kernel build, no
CUDA) when they are imported."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
EXAMPLES = os.path.join(ROOT, "examples")


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _twins():
    return [os.path.join(EXAMPLES, f) for f in sorted(os.listdir(EXAMPLES))
            if f.endswith("_torch.py")]


def _module_name(path):
    rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# the modules of the farm slice and of the LM serving slice, which every
# check below must reach
FARM_SLICE = ("repro_torch.serve", "repro_torch.serve.slots",
              "repro_torch.sim.ensemble", "repro_torch.sim.farm",
              "repro_torch.sim.service", "repro_torch.kernels.jacobi_cuda")
LM_SLICE = ("repro_torch.models.config", "repro_torch.configs.registry",
            "repro_torch.configs.zamba2_1p2b", "repro_torch.configs.llama3_8b",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.kernels.attention", "repro_torch.kernels.attention_cuda",
            "repro_torch.kernels.ssd", "repro_torch.kernels.ssd_cuda",
            "repro_torch.models.blocks", "repro_torch.models.mamba2",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.models.multimodal",
            "repro_torch.configs.musicgen_large",
            "repro_torch.configs.paligemma_3b")
# the observability and durability slice, and the leftovers ported with it
DURABLE_SLICE = ("repro_torch.obs", "repro_torch.obs.metrics",
                 "repro_torch.obs.timers", "repro_torch.obs.trace",
                 "repro_torch.obs.bench", "repro_torch.obs.health",
                 "repro_torch.ckpt", "repro_torch.ckpt.checkpointer",
                 "repro_torch.jobs", "repro_torch.jobs.codec",
                 "repro_torch.jobs.store", "repro_torch.ft",
                 "repro_torch.ft.watchdog", "repro_torch.core.ccl",
                 "repro_torch.core.mol")
# the performance-accounting slice
PERF_SLICE = ("repro_torch.core.rooflinemodel", "repro_torch.core.autotune",
              "repro_torch.launch.op_cost", "repro_torch.obs.perf")
# the decomposed CFD slice (slots x shards over torch.distributed)
DIST_SLICE = ("repro_torch.launch.mesh", "repro_torch.dist",
              "repro_torch.dist.sharding", "repro_torch.dist.collectives",
              "repro_torch.dist.compression",
              "repro_torch.dist.pipeline_parallel")
CUDA_SOURCES = ("stencil3d.cu", "jacobi.cu", "attention.cu", "ssd.cu")


def test_the_checks_cover_the_farm_slice():
    modules = {_module_name(p) for p in _port_files()}
    assert set(FARM_SLICE) <= modules, set(FARM_SLICE) - modules


def test_the_checks_cover_the_lm_slice():
    modules = {_module_name(p) for p in _port_files()}
    assert set(LM_SLICE) <= modules, set(LM_SLICE) - modules


def test_the_checks_cover_the_durable_slice():
    modules = {_module_name(p) for p in _port_files()}
    assert set(DURABLE_SLICE) <= modules, set(DURABLE_SLICE) - modules


def test_the_checks_cover_the_perf_slice():
    modules = {_module_name(p) for p in _port_files()}
    assert set(PERF_SLICE) <= modules, set(PERF_SLICE) - modules


def test_the_checks_cover_the_dist_slice():
    modules = {_module_name(p) for p in _port_files()}
    assert set(DIST_SLICE) <= modules, set(DIST_SLICE) - modules


def test_every_cuda_source_is_built_and_names_its_tpu_kernel():
    from repro_torch.kernels import _build

    assert sorted(p.name for p in _build.SOURCES.values()) == \
        sorted(CUDA_SOURCES)
    csrc = os.path.join(PKG, "kernels", "csrc")
    assert sorted(os.listdir(csrc)) == sorted(CUDA_SOURCES)
    for name in CUDA_SOURCES:
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        assert "src/repro/" in text and "on an H100" in text, name
        assert "#include <torch" not in text, name   # plain C interface


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith(("jax.", "jaxlib")) or \
        name == "repro" or name.startswith("repro.")


def test_every_example_has_its_torch_twin():
    """Each example the README starts a user with has a twin on the port
    beside it."""
    refs = sorted(f[:-3] for f in os.listdir(EXAMPLES)
                  if f.endswith(".py") and not f.endswith("_torch.py"))
    twins = sorted(os.path.basename(p)[:-len("_torch.py")] for p in _twins())
    assert twins == refs, (twins, refs)


def test_no_jax_or_reference_import_in_the_source():
    offenders = []
    for path in [*_port_files(), SMOKE, *_twins()]:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, ROOT)}: {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_kernels_do_not_import_the_model_layer():
    """The kernel layer (``repro_torch.kernels``) holds the kernels, their
    wrappers and plain versions; the model layer calls it, never the other
    way round, at module level or inside a function."""
    offenders = []
    for path in _port_files():
        if not _module_name(path).startswith("repro_torch.kernels"):
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names
                          if n.startswith(("repro_torch.models",
                                           "repro_torch.serve"))]
    assert not offenders, offenders


def _marks(func) -> set:
    out = set()
    for dec in func.decorator_list:
        node = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "mark":
            out.add(node.attr)
    return out


def test_card_tests_carry_the_cuda_marker_and_skip_in_the_fixture():
    """A test that takes the ``card`` fixture (which skips without a CUDA
    device) carries ``@pytest.mark.cuda``, and every ``cuda``-marked test
    takes the fixture — so the CPU lane skips them at run time and every
    xdist worker collects the same tests."""
    offenders = []
    tests_dir = os.path.join(ROOT, "tests")
    for fname in sorted(os.listdir(tests_dir)):
        if not (fname.startswith("test_torch_") and fname.endswith(".py")):
            continue
        with open(os.path.join(tests_dir, fname)) as f:
            tree = ast.parse(f.read(), filename=fname)
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
                takes_card = "card" in {a.arg for a in node.args.args}
                if takes_card != ("cuda" in _marks(node)):
                    offenders.append(f"{fname}::{node.name}")
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax_and_no_reference():
    modules = [_module_name(p) for p in _port_files()]
    code = f"""
import importlib, importlib.util, json, sys
for name in {modules!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {SMOKE!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)          # defines main(); does not run it
for i, path in enumerate({_twins()!r}):  # the twins define main() only
    spec = importlib.util.spec_from_file_location(f"twin{{i}}", path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    assert callable(twin.main), path
from repro_torch.kernels import (
    _build, attention_cuda, jacobi_cuda, ssd_cuda, stencil3d_cuda)
print(json.dumps({{
    "bad": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "repro" or m.startswith("repro.")),
    "built": bool(_build.build_info),
    "lib_loaded": sum(w._lib.cache_info().currsize for w in
                      (stencil3d_cuda, jacobi_cuda, attention_cuda, ssd_cuda))
                  + _build.load.cache_info().currsize,
    "has_main": callable(smoke.main),
    "slices": all(m in sys.modules
                  for m in {FARM_SLICE + LM_SLICE + DURABLE_SLICE
                            + PERF_SLICE + DIST_SLICE!r}),
}}))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "built": False, "lib_loaded": 0,
                   "has_main": True, "slices": True}, got
