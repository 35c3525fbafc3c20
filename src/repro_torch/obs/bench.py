"""``BENCH_*.json`` — the fixed schema of the performance trajectory.

The port of ``repro.obs.bench``: the same envelope and schema string; the
host block names torch and the CUDA device instead of jax.

A bench trajectory is a series of ``BENCH_<name>.json`` documents, one per
benchmark run, comparable across runs because every file carries the same
envelope: schema version, bench name, creation time, host fingerprint
(backend, device count, versions), pass verdict, wall time, and the
bench's own numbers under ``metrics``.  ``validate_bench`` names every
problem of a malformed document at once.
"""
from __future__ import annotations

import json
import os
import platform
import re
import time

SCHEMA = "repro.bench.v1"

_NAME_RE = re.compile(r"^[a-z0-9_]+$")

# field -> accepted types (the v1 envelope; ``metrics`` is free-form)
_ENVELOPE = {
    "schema": str,
    "bench": str,
    "created_unix": (int, float),
    "host": dict,
    "passed": bool,
    "wall_s": (int, float),
    "metrics": dict,
}

_HOST_FIELDS = ("backend", "device_count", "python", "torch", "device")


def host_info() -> dict:
    """The host fingerprint stamped into every bench document: ``cuda``
    and the first card's name where torch sees a card, else ``cpu``."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
    }


def make_bench_doc(name: str, metrics: dict, *, passed: bool,
                   wall_s: float, host: dict | None = None) -> dict:
    """Assemble (and validate) one schema-conforming bench document."""
    return validate_bench({
        "schema": SCHEMA,
        "bench": name,
        "created_unix": time.time(),
        "host": host if host is not None else host_info(),
        "passed": bool(passed),
        "wall_s": float(wall_s),
        "metrics": dict(metrics),
    })


def validate_bench(doc: dict) -> dict:
    """Check ``doc`` against the v1 envelope; returns it or raises
    ``ValueError`` naming every problem at once."""
    problems = []
    if not isinstance(doc, dict):
        raise ValueError(f"bench document must be a dict, got {type(doc)}")
    for field, types in _ENVELOPE.items():
        if field not in doc:
            problems.append(f"missing field {field!r}")
        elif not isinstance(doc[field], types) or (
                types is not bool and isinstance(doc[field], bool)):
            # bool is an int subclass: reject True as a number
            problems.append(
                f"field {field!r} has type {type(doc[field]).__name__}")
    if isinstance(doc.get("schema"), str) and doc["schema"] != SCHEMA:
        problems.append(f"schema is {doc['schema']!r}, expected {SCHEMA!r}")
    if isinstance(doc.get("bench"), str) and not _NAME_RE.match(doc["bench"]):
        problems.append(f"bench name {doc['bench']!r} must match "
                        f"{_NAME_RE.pattern}")
    if isinstance(doc.get("host"), dict):
        for f in _HOST_FIELDS:
            if f not in doc["host"]:
                problems.append(f"host missing {f!r}")
    if problems:
        raise ValueError("invalid bench document: " + "; ".join(problems))
    return doc


def write_bench(doc: dict, out_dir: str = ".") -> str:
    """Validate and write ``BENCH_<name>.json``; returns the path."""
    validate_bench(doc)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"BENCH_{doc['bench']}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    return path


def load_bench(path: str) -> dict:
    with open(path) as f:
        return validate_bench(json.load(f))
