"""Ensemble executor: one batched step advances every resident simulation.

The device half of the simulation farm, the port of ``repro.sim.ensemble``.
Every resident simulation lives on a leading *slot* axis of the field state
``(S, X, Y, Z)`` and of the per-simulation scalar struct (``(S,)`` tensors
of ``ns3d.PARAM_KEYS``: viscosity, dt, lid velocity, forcing), and the
solver's step runs on the whole batch: each kernel launches once for all
slots, with each slot's parameters in its own table row (CUDA template) or
broadcast as ``(S, 1, 1, 1)`` (TORCH template).  The reference ``vmap``s the
serial step; the port writes the slot axis out and keeps the reference's
contract: a farm slot equals a serial run of the same request bitwise, and
so does *chunked* stepping — a plain loop of ``k`` batched steps, the port
of the reference's ``fori_loop`` chunk — against single steps.

Per-slot scalars are host numpy values, mirrored to the device only when an
admission or a release changes them: steps between admissions copy nothing
from the host.

With ``health_window=K`` the executor also keeps a device-side
``(slots, K, N_DIAG)`` health ring: after each chunk the solver's
``health_diagnostics`` run once on the chunk's final slot batch and
shift-append one row a slot (the newest last).  The diagnostics only read
the fields, so the trajectories are bitwise those without the ring; the
ring reaches the host only through :meth:`EnsembleExecutor.read_health`.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cfd.ns3d import PARAM_KEYS, CFDConfig, NavierStokes3D
from repro_torch.obs.health import N_DIAG

VELOCITY = ("vx", "vy", "vz")


def stack_trees(trees: list[dict]) -> dict:
    """Stack identically-keyed dicts of tensors on a new slot axis 0."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def host_params(config: CFDConfig) -> dict:
    """A request's per-simulation scalars as host floats (``PARAM_KEYS``);
    float32 rounds them exactly as ``ns3d.params_from_config`` does."""
    fx, fy, fz = config.forcing
    return dict(nu=config.nu, dt=config.dt, lid_velocity=config.lid_velocity,
                fx=fx, fy=fy, fz=fz)


def make_ensemble_step(solver: NavierStokes3D, health_window: int = 0):
    """``run_k(state, params, k)``: ``k`` batched steps of ``solver``'s step
    over the whole slot batch, launched without a host sync.

    With ``health_window > 0`` it is ``run_k(state, params, ring, k) ->
    (state, ring)``: after the ``k`` steps the diagnostics of the final
    batch, one ``(slots, N_DIAG)`` row whose step column is 0 (the
    executor stamps the step on the host when the ring is read), replace
    the ring's oldest row and become its newest.  Nothing feeds back into
    the fields."""

    def run_k(state: dict, params: dict, k: int) -> dict:
        for _ in range(int(k)):
            state = solver._step_local(state, params)
        return state

    if not health_window:
        return run_k

    def run_k_health(state: dict, params: dict, ring: torch.Tensor, k: int):
        state = run_k(state, params, k)
        diag = solver.health_diagnostics(state, params)      # (S, N_DIAG-1)
        row = torch.cat([torch.zeros_like(diag[:, :1]), diag], dim=1)
        return state, torch.cat([ring[:, 1:], row[:, None]], dim=1)

    return run_k_health


class EnsembleExecutor:
    """Slot-stacked state + the batched step that advances it.

    Owns no scheduling policy: slots are written/read by index, every step
    advances all of them (idle slots compute finite garbage that the farm
    ignores — the padding-batch trade of LM serving).
    """

    def __init__(self, config: CFDConfig, n_slots: int,
                 solver: NavierStokes3D | None = None, run_k=None,
                 device=None, telemetry=None, health_window: int = 0):
        self.tel = obs.resolve(telemetry)
        self.config = config
        self.n_slots = n_slots
        self.health_window = int(health_window)
        self.solver = solver if solver is not None else NavierStokes3D(
            config, device)
        self.device = self.solver.device
        self._run_k = run_k if run_k is not None else make_ensemble_step(
            self.solver, self.health_window)
        self._fresh = self.solver.init_state()   # one slot's initial state
        self.state = stack_trees([self._fresh] * n_slots)
        # the device health ring, (slots, K, N_DIAG), newest row last.
        # Column 0 is the step: -1 marks a row never written; read_health
        # stamps the others from _ring_steps, the host's record of each
        # chunk's last device step, so the device keeps no step counter.
        # Admission does not reset a slot's rows: the monitor drops rows
        # stamped before the admission.
        self.health_ring = None
        self.steps_taken = 0
        self._ring_steps: deque | None = None
        if self.health_window:
            ring = torch.zeros((n_slots, self.health_window, N_DIAG),
                               dtype=torch.float32, device=self.device)
            ring[..., 0] = -1.0
            self.health_ring = ring
            self._ring_steps = deque(maxlen=self.health_window)
        # per-slot scalars: host-authoritative, mirrored to the device only
        # when admission dirties them
        self.params = {k: np.zeros((n_slots,), np.float32) for k in PARAM_KEYS}
        self.params["dt"][:] = np.float32(config.dt)   # idle slots stay finite
        self._params_dev: dict | None = None

    # -- slot I/O -------------------------------------------------------------
    def write_slot(self, slot: int, params: dict, state: dict | None = None):
        """Admit a simulation: install its parameters and (re)set its fields.

        ``state=None`` writes the case's fresh initial state (a new run); a
        dict of tensors (on any device) readmits an evicted simulation or
        brings a scenario's initial fields.  The batch is updated in place,
        one slot's rows; a state that does not fit raises before anything
        is written.
        """
        src = self._fresh if state is None else state
        if set(src) != set(self.state):
            raise ValueError(f"slot state has fields {sorted(src)}, the farm "
                             f"{sorted(self.state)}")
        for k, full in self.state.items():
            if tuple(src[k].shape) != tuple(full.shape[1:]):
                raise ValueError(f"slot field {k!r} has shape "
                                 f"{tuple(src[k].shape)}, the farm "
                                 f"{tuple(full.shape[1:])}")
        with self.tel.section("ensemble.write_slot"):
            for k, full in self.state.items():
                full[slot].copy_(src[k])
            self.tel.fence(self.state)
        for k in PARAM_KEYS:
            self.params[k][slot] = np.float32(params[k])
        self._params_dev = None

    def read_slot(self, slot: int) -> dict:
        """Host copy of one simulation's fields (CPU tensors that share no
        memory with the batch)."""
        with self.tel.section("ensemble.read_slot"):
            return {k: v[slot].to("cpu", copy=True)
                    for k, v in self.state.items()}

    def state_template(self) -> dict:
        """CPU zeros with one slot's field shapes and dtypes: the restore
        target of an eviction spilled to disk."""
        return {k: torch.zeros(v.shape, dtype=v.dtype)
                for k, v in self._fresh.items()}

    def clear_slot(self, slot: int):
        """Park a freed slot on benign parameters (finite garbage compute)."""
        for k in PARAM_KEYS:
            self.params[k][slot] = np.float32(
                self.config.dt if k == "dt" else 0.0)
        self._params_dev = None

    # -- stepping -------------------------------------------------------------
    def _device_params(self) -> dict:
        if self._params_dev is None:
            self._params_dev = {k: torch.from_numpy(v.copy()).to(self.device)
                                for k, v in self.params.items()}
        return self._params_dev

    def step_many(self, k: int):
        """Advance the whole slot batch ``k`` steps."""
        if self.health_ring is None:
            self.state = self._run_k(self.state, self._device_params(), k)
        else:
            self.state, self.health_ring = self._run_k(
                self.state, self._device_params(), self.health_ring, k)
            # the row written this chunk was sampled at its last step
            self._ring_steps.append(self.steps_taken + int(k) - 1)
        self.steps_taken += int(k)

    def step_args(self, k: int, device="meta") -> tuple:
        """The arguments of one ``run_k`` call of ``k`` batched steps,
        ``(state, params[, ring], k)`` with the health ring when it is on,
        as empty tensors of the live shapes and dtypes on ``device``: what
        a cost trace runs (the reference lowers its live arrays; here the
        trace runs on ``meta`` twins, so the live batch is never read or
        changed)."""
        def twin(t):
            return torch.empty(t.shape, dtype=t.dtype, device=device)

        args = [{f: twin(t) for f, t in self.state.items()},
                {f: torch.empty(v.shape, dtype=torch.float32, device=device)
                 for f, v in self.params.items()}]
        if self.health_ring is not None:
            args.append(twin(self.health_ring))
        return (*args, int(k))

    def cost_step(self):
        """``run_k`` of this executor's batched step on the solver's
        ``meta`` twin (``NavierStokes3D.cost_twin``): the step a cost trace
        runs on :meth:`step_args`, with the health ring when it is on."""
        return make_ensemble_step(self.solver.cost_twin(), self.health_window)

    def read_health(self) -> np.ndarray:
        """Host copy of the ``(slots, K, N_DIAG)`` health ring: the one
        device-to-host copy of the health path, which the farm makes only
        at its ``check_steady_every`` harvest boundaries.  Column 0 of the
        last ``len(_ring_steps)`` rows is stamped with each row's device
        step; older rows keep the -1 of a row never written."""
        rings = self.health_ring.cpu().numpy().copy()
        if self._ring_steps:
            rings[:, -len(self._ring_steps):, 0] = np.asarray(
                self._ring_steps, np.float32)
        return rings

    def kinetic_energy(self) -> np.ndarray:
        """(n_slots,) per-slot kinetic energy (steady-state detection), each
        reduced by the serial path's calls on the slot's own grid."""
        ke = torch.stack([
            NavierStokes3D.kinetic_energy_device(
                {f: self.state[f][s] for f in VELOCITY})
            for s in range(self.n_slots)])
        return ke.cpu().numpy()

    def residuals(self, prev_state: dict) -> np.ndarray:
        """(n_slots,) per-slot ``||u_now - u_prev||_inf / dt`` over the
        velocity fields — the steady-state residual of the resident batch
        relative to ``prev_state`` (normally the state one step ago).  A max
        is exact in any order, so one batched reduction serves all slots."""
        m = torch.stack([(self.state[f] - prev_state[f]).abs().amax(dim=(1, 2, 3))
                         for f in VELOCITY]).amax(dim=0)
        dt = self._device_params()["dt"]
        return (m / torch.clamp(dt, min=1e-30)).cpu().numpy()
