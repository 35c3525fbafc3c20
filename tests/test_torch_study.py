"""The design-study scripts at the repository root, on the CPU.

``kernel_study.py`` and ``attention_study.py`` build variants of the CUDA
sources by replacing one design choice; each replacement must find its text
in the committed source exactly once, or the variant would silently be the
design itself.  Like ``chip_smoke.py`` they import neither ``jax`` nor the
reference package, since the card's machine has neither.
"""
from __future__ import annotations

import ast
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SCRIPTS = ("kernel_study.py", "attention_study.py")


def _load(script):
    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(ROOT, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edits():
    study = _load("kernel_study.py")
    for source, name, edits in study.VARIANTS:
        yield f"{source}-{name}", f"{source}.cu", edits
    for name, edits in _load("attention_study.py").VARIANTS:
        yield f"attention-{name}", "attention.cu", edits


EDITS = {key: (cu, edits) for key, cu, edits in _edits()}


@pytest.mark.parametrize("variant", list(EDITS))
def test_each_variant_edit_occurs_once_in_its_source(variant):
    cu, edits = EDITS[variant]
    with open(os.path.join(CSRC, cu)) as f:
        text = f.read()
    for old, new in edits:
        assert text.count(old) == 1, (variant, old)
        assert old != new


@pytest.mark.parametrize("script", SCRIPTS)
def test_study_scripts_import_no_jax_and_no_reference(script):
    with open(os.path.join(ROOT, script)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_kernel_study_covers_both_kernels_and_every_design_axis():
    study = _load("kernel_study.py")
    axes = {(source, name.rstrip("0123456789x")) for source, name, _ in
            study.VARIANTS}
    assert axes == {("jacobi", "seg"), ("jacobi", "tile"), ("jacobi", "ahead"),
                    ("jacobi", "threads"),
                    ("jacobi", "mul_sixth"), ("ssd", "heads"),
                    ("ssd", "tf32_once"), ("ssd", "tail_mmas"),
                    ("stencil3d", "contract"),
                    ("stencil3d", "div_op"), ("stencil3d", "div"),
                    ("stencil3d", "walk_unroll"),
                    ("stencil3d", "ghost_jacobi"),
                    ("stencil3d", "ghost_update"),
                    ("stencil3d", "ghost_unbounded")}
