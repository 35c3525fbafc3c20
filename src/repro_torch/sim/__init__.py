"""Simulation runtime: the scenario registry (the farm arrives later)."""
from repro_torch.sim.scenarios import (
    ParamSpec, Scenario, UnknownScenarioError, get_scenario,
    register_scenario, scenario_names, unregister_scenario,
)

__all__ = [
    "ParamSpec", "Scenario", "UnknownScenarioError", "get_scenario",
    "register_scenario", "scenario_names", "unregister_scenario",
]
