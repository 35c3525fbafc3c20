"""Million grid-cell updates a second: every cell of every grid advanced
one step in the window (serial: cells x steps; farm: cells x live
slot-steps), over the window's wall time."""


def read(rec: dict) -> float | None:
    if not rec["window_s"] > 0:
        return None
    return rec["work_cells"] / rec["window_s"] / 1e6
