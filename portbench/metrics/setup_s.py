"""Seconds from the process's start to the window's first step: imports,
the kernels' build or load, the fields made and taken in, the warm-up.
The correctness check's own copies are not counted."""


def read(rec: dict) -> float | None:
    return rec["setup_s"]
