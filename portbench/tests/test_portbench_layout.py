"""The benchmark's files: found by name, within the contract, free of JAX."""
import ast
import json
import re
import shutil
import subprocess
import sys

import compare
import harness
import run

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_every_name_in_the_benchmark_has_its_file():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert harness.config(c["name"])["name"] == c["name"]
        assert harness.config(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        wl = harness.workload(w["name"])
        assert (wl["name"], wl["config"], wl["chips"]) == (
            w["name"], w["config"], w["chips"])
        assert callable(harness.module("drivers", wl["driver"]).run)
        assert {"intake_diff", "start_gap", "window_gap"} <= set(
            wl["limits"]) <= set(compare.NAMES)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in E2E
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in E2E and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for w in BENCH["workloads"]:
        e2e = run.metrics_for(w["name"], False, BENCH)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert run.metrics_for(w["name"], True, BENCH)


def test_a_new_configuration_cell_and_metric_are_found_with_no_edit(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = dict(harness.config("cavity3d-re100-n512"),
               name="cavity3d-re100-n384", grid=[384, 384, 384])
    (root / "configs" / "cavity3d-re100-n384.json").write_text(
        json.dumps(cfg))
    wl = dict(harness.workload("cavity512.solve"), name="cavity384.solve",
              config="cavity3d-re100-n384")
    (root / "workloads" / "cavity384.solve.json").write_text(json.dumps(wl))
    (root / "metrics" / "step.count.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    assert harness.config("cavity3d-re100-n384", root)["grid"] == [384] * 3
    assert harness.workload("cavity384.solve", root)["driver"] == "serial"
    assert harness.module("metrics", "step.count", root).read(
        {"steps": 7}) == 7.0
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "step.count", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "solver step",
         "moves": "mcups", "workloads": ["cavity384.solve"]}])
    assert [m["name"] for m in run.metrics_for("cavity384.solve", True,
                                               bench)] == ["step.count"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package_or_reads_benchmarks():
    files = sorted(harness.HERE.rglob("*.py"))
    assert files
    for path in files:
        tops = set(_imports(path))
        assert not tops & set(harness.FORBIDDEN_MODULES), path
        assert "benchmarks" not in tops, path
        assert "benchmarks" + "/" not in path.read_text(), path
    # the yardstick takes nothing from the program
    for path in files:
        rel = path.relative_to(harness.HERE).as_posix()
        if rel.startswith(("reference/", "cost/", "metrics/")) or rel in (
                "compare.py", "traffic.py", "traceread.py", "window.py"):
            assert "repro_torch" not in set(_imports(path)), rel


def test_a_cpu_drive_loads_no_forbidden_module():
    code = (
        "import sys, time; sys.path[:0] = [{p!r}, {s!r}]\n"
        "from conftest import small\n"
        "import harness, run\n"
        "wl, cfg = small('cavity512.solve', n=8)\n"
        "res = run.execute(wl, cfg, 1, 0.2, False, 'cpu', time.perf_counter(),"
        " harness.benchmark())\n"
        "print(res['correct'], harness.forbidden_loaded())\n"
    ).format(p=str(harness.HERE / "tests"), s=str(harness.HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_the_command_refuses_to_run_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cavity512.solve",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr
