"""Durable wire format for simulation requests.

The port of ``repro.jobs.codec``, byte-compatible with it: a payload either
package encodes, the other decodes.  A
:class:`~repro_torch.sim.farm.SimRequest` splits into two halves: the
*description* (the :class:`~repro_torch.cfd.ns3d.CFDConfig` plus run knobs
— small, structured, human-inspectable) and the optional *initial fields*
(arrays, potentially hundreds of megabytes).  The store keeps the
description as a JSON text column — queryable during incidents, exact float
round-trip through ``repr``-based JSON numbers — and the fields as one npz
blob, so a queued job survives a process crash byte for byte:
``decode_request(*encode_request(req))`` rebuilds a request whose config
compares equal and whose initial fields are bitwise the originals.

The port's config has no ``interpret`` field (the Pallas interpret mode
has no torch meaning).  Its payload carries it at its default, so the
reference's decoder reads it, and it reads a reference payload whose
``interpret`` is false; true raises.  ``decomposition`` travels both ways
in the reference's layout (a list of ``[array axis, mesh axis]`` pairs).

``sid`` is deliberately NOT part of the payload: it is per-process farm
bookkeeping, reassigned on every (re)admission, while the durable identity
is the store's ``job_id``.
"""
from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import torch

from repro_torch.ckpt.checkpointer import to_numpy
from repro_torch.cfd.ns3d import CFDConfig

PAYLOAD_VERSION = 1

# the reference's config field the port's config lacks, at its default
_REFERENCE_ONLY = {"interpret": False}


def config_to_dict(cfg: CFDConfig) -> dict:
    """JSON-ready dict of a CFDConfig (tuples become lists), with the
    reference's ``interpret`` at its default."""
    return {**dataclasses.asdict(cfg), **_REFERENCE_ONLY}


def config_from_dict(d: dict) -> CFDConfig:
    """Rebuild a CFDConfig from its JSON form (either package's),
    restoring the tuple-typed fields JSON flattened to lists — a
    round-tripped config compares ``==`` to the original, and hashable
    tuples are part of the farm's static signature."""
    d = dict(d)
    if d.pop("interpret", False):
        raise ValueError("config asks for the Pallas interpret mode, which "
                         "the port does not have")
    d["shape"] = tuple(int(x) for x in d["shape"])
    d["forcing"] = tuple(float(x) for x in d["forcing"])
    d["decomposition"] = tuple(
        (int(axis), str(name)) for axis, name in d.get("decomposition", ()))
    return CFDConfig(**d)


def encode_request(req) -> tuple[str, bytes | None]:
    """``(payload_json, init_npz)`` of a SimRequest.

    ``init_npz`` is None when the request carries no initial fields (the
    scenario ICs them in-solver); otherwise a compressed npz archive with
    one entry per field (tensors on any device, or arrays).
    """
    payload = json.dumps({
        "version": PAYLOAD_VERSION,
        "config": config_to_dict(req.config),
        "steps": req.steps,
        "tag": req.tag,
        "steady_tol": req.steady_tol,
        "residual_tol": req.residual_tol,
        "priority": req.priority,
        "step0": req.step0,
    }, sort_keys=True)
    blob = None
    if req.init_state is not None:
        buf = io.BytesIO()
        np.savez_compressed(
            buf, **{k: to_numpy(v) for k, v in req.init_state.items()})
        blob = buf.getvalue()
    return payload, blob


def decode_request(payload: str, init_npz: bytes | None = None):
    """Rebuild the SimRequest a payload row describes (``sid=None`` — the
    farm assigns a fresh one at submission); initial fields come back as
    CPU tensors."""
    from repro_torch.sim.farm import SimRequest   # lazy: avoid import cycle

    doc = json.loads(payload)
    if doc.get("version") != PAYLOAD_VERSION:
        raise ValueError(
            f"unsupported job payload version {doc.get('version')!r} "
            f"(this build reads {PAYLOAD_VERSION})")
    init_state = None
    if init_npz is not None:
        with np.load(io.BytesIO(init_npz), allow_pickle=False) as data:
            init_state = {k: torch.from_numpy(np.asarray(data[k]))
                          for k in data.files}
    return SimRequest(
        config=config_from_dict(doc["config"]),
        steps=int(doc["steps"]),
        tag=str(doc.get("tag", "")),
        steady_tol=doc.get("steady_tol"),
        residual_tol=doc.get("residual_tol"),
        priority=int(doc.get("priority", 0)),
        init_state=init_state,
        step0=int(doc.get("step0", 0)),
    )
