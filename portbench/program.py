"""The benchmark's hold on the system under test: the port's front door.

The seeded initial fields enter through the program's own intake: a
scenario registered with the port's public plugin registry, the cavity's
builder and parameters with an initial-condition routine that lays the
benchmark's fields (``traffic.initial_fields``).  ``Runtime.prepare`` runs
it in the INITIAL bin, and a farm request built by ``Runtime.submit``
carries its output as ``init_state``.
"""
from __future__ import annotations

import harness
import traffic

SCENARIO = "portbench_cavity"
FIELDS = traffic.FIELDS
MASKS = ("mask_vx", "mask_vy", "mask_vz")


def register(cfg: dict):
    harness.use_program()
    from repro_torch.sim.scenarios import (
        ParamSpec, Scenario, get_scenario, register_scenario,
    )

    cavity = get_scenario(cfg["case"])
    ic = cfg["initial_fields"]

    def init_fields(solver, state, *, seed, member):
        fields = traffic.initial_fields(
            solver.config.shape, int(seed), int(member), modes=ic["modes"],
            amplitude=ic["amplitude"],
            lid_velocity=solver.config.lid_velocity, device=solver.device)
        return dict(state, **fields)

    register_scenario(Scenario(
        name=SCENARIO,
        description="the cavity from the benchmark's seeded initial fields",
        builder=cavity.builder, params=cavity.params,
        ic_params={"seed": ParamSpec(0.0, "the run's seed"),
                   "member": ParamSpec(0.0, "the member's index")},
        init_fields=init_fields), replace=True)


def runtime(cfg: dict, device, n_slots: int = 1):
    """The port's Runtime for ``cfg``, its solver settings as the file
    states them."""
    from repro_torch import api

    nx, _, nz = cfg["grid"]
    return api.runtime(n=nx, nz=nz, backend=cfg["backend"],
                       device=str(device), n_slots=n_slots,
                       check_every=cfg["check_every"],
                       jacobi_iters=cfg["jacobi_iters"],
                       jacobi_omega=cfg["jacobi_omega"],
                       fused_sweeps=cfg["fused_sweeps"])


def run_params(cfg: dict, seed: int, member: int, re: float) -> dict:
    """The per-run keyword arguments of ``prepare``/``submit``."""
    return dict(re=re, lid_velocity=cfg["lid_velocity"], seed=seed,
                member=member)


def to_host(state: dict, keys, index=None) -> dict:
    """Host copies of ``state[k]`` (of slot ``index`` when given)."""
    return {k: (state[k] if index is None else state[k][index]).to(
        "cpu", copy=True) for k in keys}
