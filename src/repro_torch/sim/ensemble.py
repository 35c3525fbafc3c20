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

Two mesh placements compose (the farm's slots × shards):

* **slot parallelism** — the slot axis spreads over the ``slot_axis`` mesh
  axis (``dist.sharding.slot_spec``): each rank of that axis holds
  ``n_slots / |slot_axis|`` slots, or every slot when that does not
  divide.  Slots never interact, so the spread batch is bitwise the one
  batch.
* **per-slot grid decomposition** — with ``config.decomposition``, each
  slot's grid is split over the named mesh axes as well
  (``dist.sharding.slot_field_spec``), and the step exchanges ghosts over
  them; a slot stays bitwise the serial decomposed run.

Every rank runs the same host code.  What the host decides on (kinetic
energy, residuals, health frames) is a per-slot vector reduced over the
decomposition and all-gathered over the slot axis, so every rank reads the
same numbers.  A slot's fields reach the host through
:meth:`EnsembleExecutor.read_slot`, gathered to one rank
(:meth:`EnsembleExecutor.slot_root` for an eviction, global rank 0 for a
result, and for an eviction too when a job store, which rank 0 writes,
holds it), and return through :meth:`EnsembleExecutor.write_slot` from one rank
(``src``: an eviction's gather, or a snapshot rank 0 read from the store)
or from every rank (a request's initial fields).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.cfd.ns3d import PARAM_KEYS, CFDConfig, NavierStokes3D
from repro_torch.core.halo import AxisLink, P2PTransport
from repro_torch.launch.mesh import mesh_extents
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


def plan_decomposition(config: CFDConfig, mesh,
                       slot_axis: str | None = None
                       ) -> tuple[CFDConfig, dict]:
    """Resolve ``config.decomposition`` against the farm mesh.

    Returns ``(solver_config, active)`` where ``active`` maps array axis ->
    mesh axis for every decomposed axis whose mesh extent is > 1, and
    ``solver_config`` is ``config`` with exactly that decomposition.  Axes
    of extent 1 are dropped: a 1-shard mesh degrades to the plain
    slot-parallel path instead of exchanging with itself.

    Raises ``ValueError`` when a decomposition is requested without a
    mesh, or fails ``dist.sharding.validate_decomposition`` (duplicate /
    out-of-range array axis, unknown mesh axis, decomposing over the slot
    axis).  All validation runs BEFORE the extent-1 filter, so a
    mis-assembled config fails identically on a 1-shard mesh and a large
    one.
    """
    if not config.decomposition:
        return config, {}
    if mesh is None:
        raise ValueError(
            f"config.decomposition={tuple(config.decomposition)!r} asks for "
            "per-slot grid decomposition, which needs a farm mesh naming "
            "those axes (SimulationFarm(..., mesh=make_mesh((slots, shards), "
            "('slot', 'shard')))); got mesh=None")
    from repro_torch.dist.sharding import validate_decomposition

    extents = mesh_extents(mesh)
    pairs = validate_decomposition(config.decomposition, len(config.shape),
                                   tuple(extents), slot_axis=slot_axis)
    active = {a: n for a, n in pairs if extents[n] > 1}
    solver_cfg = dataclasses.replace(
        config, decomposition=tuple(sorted(active.items())))
    return solver_cfg, active


def make_ensemble_step(solver: NavierStokes3D, health_window: int = 0):
    """``run_k(state, params, k)``: ``k`` batched steps of ``solver``'s step
    over the whole slot batch, launched without a host sync.

    With ``health_window > 0`` it is ``run_k(state, params, ring, k) ->
    (state, ring)``: after the ``k`` steps the diagnostics of the final
    batch, one ``(slots, N_DIAG)`` row whose step column is 0 (the
    executor stamps the step on the host when the ring is read), replace
    the ring's oldest row and become its newest.  Nothing feeds back into
    the fields.

    On a mesh the batch is the rank's own slots and blocks: the same
    function runs on every rank, exchanging ghosts through the solver's
    driver (the reference's ``shard_map`` of the vmapped step)."""

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


def counted_step(twin: NavierStokes3D, health_window: int = 0):
    """``make_ensemble_step`` of a solver's ``meta`` twin whose
    ``transport`` attribute is the twin's count transport (None when it
    is undecomposed): each call books exactly its own exchanges, so after
    a cost trace (which runs the step twice) it holds one call's."""
    run_k = make_ensemble_step(twin, health_window)
    transport = twin.driver.transport

    def step(*args):
        if transport is not None:
            transport.reset()
        return run_k(*args)

    step.transport = transport
    return step


class EnsembleExecutor:
    """Slot-stacked state + the batched step that advances it.

    Owns no scheduling policy: slots are written/read by index, every step
    advances all of them (idle slots compute finite garbage that the farm
    ignores — the padding-batch trade of LM serving).  On a mesh the
    resident batch is this rank's slots (``local_slots``), each its block
    of the grid.
    """

    def __init__(self, config: CFDConfig, n_slots: int,
                 solver: NavierStokes3D | None = None, run_k=None,
                 device=None, mesh=None, slot_axis: str = "data",
                 telemetry=None, health_window: int = 0):
        self.tel = obs.resolve(telemetry)
        solver_cfg, decomp = plan_decomposition(
            config, mesh, slot_axis=slot_axis if mesh is not None else None)
        self.config = config
        self.decomposition = decomp    # active per-slot grid decomposition
        self.n_slots = n_slots
        self.mesh = mesh
        self.slot_axis = slot_axis
        self.health_window = int(health_window)
        self.solver = solver if solver is not None else NavierStokes3D(
            solver_cfg, device, mesh if decomp else None)
        self.device = self.solver.device
        self._run_k = run_k if run_k is not None else make_ensemble_step(
            self.solver, self.health_window)
        # the slot layout: which slots this rank holds, and the link that
        # all-gathers per-slot vectors over the slot axis
        self.slot_link: AxisLink | None = None
        first, n_local = 0, n_slots
        if mesh is not None:
            from repro_torch.dist.sharding import slot_spec

            if slot_spec(mesh, n_slots, axis=slot_axis)[0] is not None:
                self.slot_link = AxisLink.from_mesh(mesh, slot_axis,
                                                    P2PTransport())
                n_local = n_slots // self.slot_link.size
                first = self.slot_link.index * n_local
        self.local_slots = range(first, first + n_local)
        self._fresh = self.solver.init_state()   # one slot's initial block
        self.state = stack_trees([self._fresh] * n_local)
        # the device health ring, (local slots, K, N_DIAG), newest row
        # last.  Column 0 is the step: -1 marks a row never written;
        # read_health stamps the others from _ring_steps, the host's record
        # of each chunk's last device step, so the device keeps no step
        # counter.  Admission does not reset a slot's rows: the monitor
        # drops rows stamped before the admission.
        self.health_ring = None
        self.steps_taken = 0
        self._ring_steps: deque | None = None
        if self.health_window:
            ring = torch.zeros((n_local, self.health_window, N_DIAG),
                               dtype=torch.float32, device=self.device)
            ring[..., 0] = -1.0
            self.health_ring = ring
            self._ring_steps = deque(maxlen=self.health_window)
        # per-slot scalars: host-authoritative (every slot, on every rank),
        # mirrored to the device — this rank's slots — only when admission
        # dirties them
        self.params = {k: np.zeros((n_slots,), np.float32) for k in PARAM_KEYS}
        self.params["dt"][:] = np.float32(config.dt)   # idle slots stay finite
        self._params_dev: dict | None = None

    # -- slot placement ---------------------------------------------------------
    def _local(self, slot: int) -> int | None:
        """``slot``'s index in this rank's batch, None if it lives
        elsewhere."""
        if slot in self.local_slots:
            return slot - self.local_slots.start
        return None

    def _rank_at(self, coords: dict) -> int:
        """The global rank at mesh coordinates ``coords`` (axis -> index;
        axes absent are 0)."""
        names = self.mesh.mesh_dim_names
        return int(self.mesh.mesh[tuple(coords.get(n, 0)
                                        for n in names)].item())

    def _coords_of(self, rank: int) -> dict:
        where = (self.mesh.mesh == rank).nonzero()[0].tolist()
        return dict(zip(self.mesh.mesh_dim_names, where))

    def slot_holders(self, slot: int) -> list[int]:
        """Every global rank that holds ``slot`` (all ranks with its slot
        coordinate; every rank when the slot axis is replicated): the
        counterpart of the reference's ``slot_sharding``."""
        ranks = self.mesh.mesh.flatten().tolist()
        if self.slot_link is None:
            return ranks
        g = slot // len(self.local_slots)
        return [r for r in ranks if self._coords_of(r)[self.slot_axis] == g]

    def slot_root(self, slot: int) -> int:
        """The first rank of ``slot``'s shard group: where an eviction
        gathers the slot (None-free: 0 without a mesh)."""
        if self.mesh is None:
            return 0
        g = slot // len(self.local_slots) if self.slot_link else 0
        return self._rank_at({self.slot_axis: g})

    def _in_root_group(self, slot: int) -> bool:
        """Does this rank belong to the group of ``slot``'s holders that
        shares the root's coordinates off the decomposition?"""
        if self._local(slot) is None:
            return False
        me = self._coords_of(dist.get_rank())
        root = self._coords_of(self.slot_root(slot))
        decomposed = set(self.decomposition.values())
        return all(me[n] == root[n] for n in me if n not in decomposed)

    def _block_slices(self, rank: int) -> tuple:
        """Rank ``rank``'s block of the global grid."""
        where = self._coords_of(rank)
        loc = self.solver.driver.local_shape
        out = []
        for a in range(3):
            name = self.decomposition.get(a)
            c = where[name] if name is not None else 0
            out.append(slice(c * loc[a], (c + 1) * loc[a]))
        return (Ellipsis, *out)

    def _move(self, tensors: list | None, src: int, dst: int,
              like: list) -> list | None:
        """Host tensors from rank ``src`` to rank ``dst`` (``like`` gives
        ``dst`` the shapes and dtypes; other ranks pass through).  Under
        NCCL they travel on this rank's card."""
        me = dist.get_rank()
        if me not in (src, dst):
            return None
        nccl = dist.get_backend() == "nccl"
        dev = torch.device("cuda", torch.cuda.current_device()) if nccl \
            else torch.device("cpu")
        if me == src:
            for t in tensors:
                dist.send(t.to(dev).contiguous(), dst)
            return None
        out = []
        for t in like:
            buf = torch.empty(t.shape, dtype=t.dtype, device=dev)
            dist.recv(buf, src)
            out.append(buf.cpu())
        return out

    # -- slot I/O -------------------------------------------------------------
    def write_slot(self, slot: int, params: dict, state: dict | None = None,
                   src: int | None = None):
        """Admit a simulation: install its parameters and (re)set its fields.

        ``state=None`` writes the case's fresh initial state (a new run); a
        dict of global fields (tensors on any device) readmits an evicted
        simulation or brings a scenario's initial fields.  On a mesh the
        fields are held by every rank (``src=None``: each holder of the slot
        cuts its block), or by rank ``src`` alone (an eviction's gather),
        which sends each holder its block.  The batch is updated in place,
        one slot's rows; a state that does not fit raises before anything
        is written.
        """
        template = self.state_template()
        if state is not None:
            if set(state) != set(template):
                raise ValueError(f"slot state has fields {sorted(state)}, "
                                 f"the farm {sorted(template)}")
            for k, want in template.items():
                if tuple(state[k].shape) != tuple(want.shape):
                    raise ValueError(f"slot field {k!r} has shape "
                                     f"{tuple(state[k].shape)}, the farm "
                                     f"{tuple(want.shape)}")
        if src is not None and self.mesh is not None:
            keys = sorted(template)
            me = dist.get_rank()
            got = None
            for r in self.slot_holders(slot):
                if r == src:
                    continue
                if me == src:
                    self._move([torch.as_tensor(state[k])[self._block_slices(r)]
                                for k in keys], src, r, [])
                elif me == r:
                    loc = self.solver.driver.local_shape
                    got = dict(zip(keys, self._move(
                        None, src, r,
                        [torch.empty(loc, dtype=template[k].dtype)
                         for k in keys])))
            if me == src and self._local(slot) is not None:
                got = {k: torch.as_tensor(state[k])[self._block_slices(me)]
                       for k in keys}
            blocks = got
        elif state is None:
            blocks = self._fresh
        elif self.decomposition:
            blocks = {k: self.solver.driver.scatter(v)
                      for k, v in state.items()}
        else:
            blocks = state
        local = self._local(slot)
        if local is not None:
            with self.tel.span("ensemble.write_slot", slot=slot):
                for k, full in self.state.items():
                    full[local].copy_(blocks[k])
        for k in PARAM_KEYS:
            self.params[k][slot] = np.float32(params[k])
        self._params_dev = None

    def read_slot(self, slot: int, dst: int | None = 0) -> dict | None:
        """Host copy of one simulation's global fields (CPU tensors that
        share no memory with the batch).  On a mesh the holders of the
        slot gather it and it lands on rank ``dst`` (global rank 0 by
        default): every rank must call this, and the others get None."""
        with self.tel.span("ensemble.read_slot", slot=slot):
            if self.mesh is None:
                return {k: v[slot].to("cpu", copy=True)
                        for k, v in self.state.items()}
            keys = sorted(self.state)
            root = self.slot_root(slot)
            whole = None
            if self._in_root_group(slot):
                local = self._local(slot)
                drv = self.solver.driver
                whole = [drv.gather(self.state[k][local]) if self.decomposition
                         else self.state[k][local].to("cpu", copy=True)
                         for k in keys]
            me = dist.get_rank()
            if root != dst:
                tmpl = self.state_template()
                moved = self._move(whole, root, dst, [tmpl[k] for k in keys])
                whole = moved if me == dst else None
            return dict(zip(keys, whole)) if me == dst else None

    def state_template(self) -> dict:
        """CPU zeros with one slot's global field shapes and dtypes: the
        restore target of an eviction spilled to disk."""
        shape = tuple(self.config.shape)
        return {k: torch.zeros(shape, dtype=v.dtype)
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
            sl = slice(self.local_slots.start, self.local_slots.stop)
            self._params_dev = {k: torch.from_numpy(v[sl].copy()).to(
                self.device) for k, v in self.params.items()}
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
                {f: torch.empty((len(self.local_slots),), dtype=torch.float32,
                                device=device)
                 for f in self.params}]
        if self.health_ring is not None:
            args.append(twin(self.health_ring))
        return (*args, int(k))

    def cost_step(self):
        """``run_k`` of this executor's batched step on the solver's
        ``meta`` twin (``NavierStokes3D.cost_twin``): the step a cost trace
        runs on :meth:`step_args`, with the health ring when it is on (see
        :func:`counted_step`)."""
        return counted_step(self.solver.cost_twin(), self.health_window)

    def _all_slots(self, local: torch.Tensor) -> np.ndarray:
        """A per-slot vector (``(local slots, ...)``) of this rank, as the
        whole farm's ``(n_slots, ...)``: all-gathered over the slot axis,
        so every rank reads the same numbers."""
        if self.slot_link is not None:
            parts = self.slot_link.transport.all_gather(self.slot_link, local)
            local = parts.reshape(-1, *local.shape[1:])
        return local.cpu().numpy()

    def read_health(self) -> np.ndarray:
        """Host copy of the ``(slots, K, N_DIAG)`` health ring: the one
        device-to-host copy of the health path, which the farm makes only
        at its ``check_steady_every`` harvest boundaries.  Column 0 of the
        last ``len(_ring_steps)`` rows is stamped with each row's device
        step; older rows keep the -1 of a row never written."""
        rings = self._all_slots(self.health_ring).copy()
        if self._ring_steps:
            rings[:, -len(self._ring_steps):, 0] = np.asarray(
                self._ring_steps, np.float32)
        return rings

    def kinetic_energy(self) -> np.ndarray:
        """(n_slots,) per-slot kinetic energy (steady-state detection), each
        reduced by the serial path's calls on the slot's own grid."""
        return self._all_slots(self.solver.kinetic_energy_device(self.state))

    def residuals(self, prev_state: dict) -> np.ndarray:
        """(n_slots,) per-slot ``||u_now - u_prev||_inf / dt`` over the
        velocity fields — the steady-state residual of the resident batch
        relative to ``prev_state`` (normally the state one step ago).  A max
        is exact in any order, so one batched reduction serves all slots
        (and ranks)."""
        m = torch.stack([(self.state[f] - prev_state[f]).abs().amax(dim=(1, 2, 3))
                         for f in VELOCITY]).amax(dim=0)
        if self.solver.driver.links:
            m = self.solver.driver.pmax(m)
        dt = self._device_params()["dt"]
        return self._all_slots(m / torch.clamp(dt, min=1e-30))
