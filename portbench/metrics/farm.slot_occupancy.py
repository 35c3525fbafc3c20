"""Live slot-steps over batched device steps x slots in the window, from
the farm's own counts (``Runtime.device_steps()``, each member's
``steps_done``): the slots a batched step spends on no member."""


def read(rec: dict) -> float | None:
    c = rec["counters"]
    if "live_slot_steps" not in c or not c["device_steps"]:
        return None
    return 100.0 * c["live_slot_steps"] / (c["device_steps"] * c["n_slots"])
