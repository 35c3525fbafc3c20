"""Simulation farm: continuous-batching ensemble runtime for CFD workloads.

Many independent parameter variants of one case resident on a slot axis,
advanced by a single batched step, with host-side admission/reclamation and
a step cache so new work of an already-seen shape builds nothing.

    ensemble.py   the device layer — slot-stacked state, one step for all
    farm.py       the scheduler — queue, slots, termination, step cache
    service.py    the front-end — submit/poll/result + evict/readmit
    scenarios.py  the registry — declarative problem specs (repro_torch.api)

New code should reach this subsystem through :mod:`repro_torch.api`.
"""
from repro_torch.sim.ensemble import EnsembleExecutor, stack_trees
from repro_torch.sim.farm import (
    SimRequest, SimResult, SimulationFarm, compile_cache_stats,
    reset_compile_cache,
)
from repro_torch.sim.scenarios import (
    ParamSpec, Scenario, UnknownScenarioError, get_scenario,
    register_scenario, scenario_names, unregister_scenario,
)
from repro_torch.sim.service import SimulationService

__all__ = [
    "EnsembleExecutor", "ParamSpec", "Scenario", "SimRequest", "SimResult",
    "SimulationFarm", "SimulationService", "UnknownScenarioError",
    "compile_cache_stats", "get_scenario", "register_scenario",
    "reset_compile_cache", "scenario_names", "stack_trees",
    "unregister_scenario",
]
