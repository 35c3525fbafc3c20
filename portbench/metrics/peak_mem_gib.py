"""The device memory the program held at its peak in the window
(``torch.cuda.max_memory_allocated``, reset as the window opens), GiB."""


def read(rec: dict) -> float | None:
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
