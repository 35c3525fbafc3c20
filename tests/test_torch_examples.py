"""The port's twins of the examples (``examples/*_torch.py``) on the CPU.

Each twin runs in this process through its ``main()`` with ``--device cpu``
at a small size.  Where the reference example is cheap at the same size it
runs too, and the numbers both print are held together: the print's own
precision (4 decimals: 1e-4, and 3 significant digits for the Taylor-Green
error) bounds the difference, the two packages' states agreeing to ~1e-7
at these sizes.  Otherwise the twin is held to the reference example's own
checks.  Without a card each twin raises on its default ``cuda`` device:
nothing falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import runpy
import subprocess
import sys

import pytest

from tests.test_torch_harness import ROOT  # installs the shim

EXAMPLES = os.path.join(ROOT, "examples")
TWINS = ("quickstart", "cavity_flow", "ensemble_sweep", "custom_kernel",
         "serve_lm")
PRINTED = 1e-4          # a number printed with 4 decimals
FLOAT = r"-?\d+\.\d+(?:e[-+]\d+)?"


def _twin(name: str, *argv: str) -> tuple[int, str]:
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", os.path.join(EXAMPLES, f"{name}_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(list(argv))
    return rc, out.getvalue()


def _reference(name: str, *argv: str) -> str:
    path = os.path.join(EXAMPLES, f"{name}.py")
    out, saved = io.StringIO(), sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


def _line(text: str, start: str) -> str:
    (line,) = [ln for ln in text.splitlines() if ln.startswith(start)]
    return line


def _numbers(line: str) -> list[float]:
    return [float(x) for x in re.findall(FLOAT, line)]


def _close(got: list, want: list, tol: float) -> bool:
    return len(got) == len(want) and all(
        abs(a - b) <= tol for a, b in zip(got, want))


def test_quickstart_twin_prints_the_reference_numbers():
    """At the reference's own (fixed) size: the scenario list, the step
    count, the Ghia deviations and the Taylor-Green error."""
    rc, got = _twin("quickstart", "--device", "cpu")
    want = _reference("quickstart")
    assert rc == 0 and "OK" in got
    for start in ("  cavity", "  taylor_green", "  kelvin_helmholtz",
                  "cavity Re=100"):
        assert _line(got, start) == _line(want, start)
    ghia = [_numbers(_line(t, "Ghia centerline")) for t in (got, want)]
    assert _close(*ghia, PRINTED), ghia
    tg = [_numbers(_line(t, "taylor_green nu")) for t in (got, want)]
    assert abs(tg[0][1] - tg[1][1]) <= 1e-2 * tg[1][1], tg   # 3 digits
    assert tg[0][0] == tg[1][0] == 0.05 and tg[0][2] == tg[1][2], tg


def test_cavity_flow_twin_prints_the_reference_numbers():
    """At n = 16 to t = 1: steps, Ghia deviations, the ASCII profile and the
    verdict (both FAILED this early; the twin exits 1), and the twin's
    divergence within the reference's bound (tests/test_cfd.py)."""
    argv = ("--n", "16", "--t-end", "1.0")
    rc, got = _twin("cavity_flow", *argv, "--device", "cpu")
    want = _reference("cavity_flow", *argv)
    assert _line(got, "steps:") == _line(want, "steps:")
    ghia = [_numbers(_line(t, "Ghia centerline")) for t in (got, want)]
    assert _close(*ghia, PRINTED), ghia
    profile = [[ln for ln in t.splitlines() if ln.startswith("  y=")]
               for t in (got, want)]
    assert len(profile[0]) == 15 and profile[0] == profile[1]
    assert _line(got, "VALIDATION") == _line(want, "VALIDATION")
    assert rc == (0 if "PASSED" in _line(want, "VALIDATION") else 1)
    assert _numbers(_line(got, "max |div u|"))[0] < 0.05


def test_ensemble_sweep_twin_prints_the_reference_numbers():
    """Eight Reynolds numbers through 4 slots at n = 12 to t = 1: dispatch
    rounds, the cache's one entry, each run's centerline minimum and
    maximum, steps and termination, and the verdict."""
    from repro.sim import farm as ref_farm
    from repro_torch.sim import farm

    argv = ("--n", "12", "--t-end", "1.0")
    farm.reset_compile_cache()       # the caches are process-wide: count
    ref_farm.reset_compile_cache()   # this run's step alone in each
    rc, got = _twin("ensemble_sweep", *argv, "--device", "cpu")
    want = _reference("ensemble_sweep", *argv)
    assert rc == 0 and got.splitlines()[-1] == want.splitlines()[-1] == "OK"
    rounds = [re.search(r"(\d+) sim-steps in .* (\d+) device dispatch",
                        t).groups() for t in (got, want)]
    assert rounds[0] == rounds[1], rounds
    assert _line(got, "compile cache") == _line(want, "compile cache")
    rows = [[ln.split() for ln in t.splitlines()
             if re.match(r"\s+\d+\s+-?\d", ln)] for t in (got, want)]
    assert len(rows[0]) == len(rows[1]) == 8
    for a, b in zip(*rows):
        assert a[0] == b[0] and a[3:] == b[3:], (a, b)     # Re, steps, end
        assert _close([float(a[1]), float(a[2])],
                      [float(b[1]), float(b[2])], PRINTED), (a, b)


def test_custom_kernel_twin_prints_the_reference_numbers():
    """The CCL text parsed alike, the generated template's kernel equal to
    the TORCH template, and the deviation from the analytic gradient the
    reference's."""
    rc, got = _twin("custom_kernel", "--device", "cpu")
    want = _reference("custom_kernel")
    assert rc == 0 and "OK" in got
    for start in ("parsed descriptor", "  variables"):
        assert _line(got, start) == _line(want, start)
    assert _numbers(_line(got, "TORCH vs CUDA"))[0] < 1e-5
    dev = [_numbers(_line(t, "mean deviation")) for t in (got, want)]
    assert _close(*dev, PRINTED), dev


def test_serve_lm_twin_serves_every_requested_token():
    """The reference example's check: every request drained with its
    12 new tokens (zamba2-1.2b's smoke config; the engine's tokens are
    held against the reference's in tests/test_torch_lm.py)."""
    rc, got = _twin("serve_lm", "--smoke", "--device", "cpu",
                    "--requests", "4")
    assert rc == 0
    m = re.search(r"\[serve\] (\d+) requests, (\d+) tokens", got)
    assert m and (int(m[1]), int(m[2])) == (4, 4 * 12), got
    assert "on cpu (TORCH)" in got
    assert len(re.findall(r"  req \d+: \[", got)) == 3


@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_a_card_on_its_default_device(name):
    """``cuda`` is every twin's default, and without a card it raises: no
    twin falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the twin would run on it")
    argv = {"serve_lm": ("--smoke",), "cavity_flow": ("--n", "8"),
            "ensemble_sweep": ("--n", "8")}.get(name, ())
    with pytest.raises(RuntimeError, match="cuda"):
        _twin(name, *argv)


def test_twin_runs_as_a_user_runs_it(tmp_path):
    """``python3 examples/custom_kernel_torch.py --device cpu``: exit 0,
    and with ``REPRO_TORCH_LAUNCHES`` it reports its launch counts (none
    on the CPU), the way a run on the card shows its kernels ran."""
    report = str(tmp_path / "launches.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_LAUNCHES=report)
    p = subprocess.run([sys.executable,
                        os.path.join(EXAMPLES, "custom_kernel_torch.py"),
                        "--device", "cpu"], env=env, capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-1500:]
    assert p.stdout.splitlines()[-1].startswith("OK")
    with open(report) as f:
        counts = json.load(f)
    assert set(counts) >= {"JACOBI_PRESSURE", "FLASH_ATTENTION",
                           "SSD_INTRA"}
    assert not any(counts.values()), counts
