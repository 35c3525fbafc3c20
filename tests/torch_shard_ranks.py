"""Rank-side jobs of ``tests/test_torch_sharded.py``,
``tests/test_torch_sharded_serve.py`` and ``tests/test_torch_sharded_sp.py``,
run by
``repro_torch.launch.mesh.spawn`` in gloo ranks on the CPU.

One launch runs every job (:func:`all_jobs`) in 4 ranks and returns numpy
data, pickled back to the test process, where the reference is loaded and
the comparisons run.  This module imports the port only: the ranks start
fast and never load JAX.
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from repro_torch import convert
from repro_torch.dist import collectives, sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.adamw import AdamW, AdamWState

FSDP_MESH = ((2, 2), ("data", "model"))
DP_MESH = ((2, 2), ("pod", "data"))


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _full(tensors: dict, placement: dict, mesh) -> dict:
    return {n: _np(sharding.full_tensor(t, placement[n], mesh))
            for n, t in tensors.items()}


def sharded_model(cfg, params_np, shard):
    """The port's model from the reference's numpy tree, cut to this
    rank's blocks."""
    lm = convert.lm_params_from_numpy(cfg, params_np, device="cpu")
    return sharding.shard_params(lm, cfg, shard)


@contextlib.contextmanager
def planted(fault: str | None):
    """``wo_without_reduce``: the first ``wo`` of each forward (one layer,
    or the hybrid's first shared-block application) skips its all-reduce
    over ``tp``; ``grad_not_divided``: the data-axis gradients are summed
    but not divided by |dp|.  Under the sequence-parallel postures:
    ``no_halo``: ``tp`` rank 1's conv prefix zeroed; ``no_relay``: every
    rank's incoming state zero; ``tp_grad_kept``: a Mamba2 leaf
    (``dt_bias``) used on a rank's block without its gradient summed over
    ``tp``; ``router_grad_kept``: the same for the router under ``a2a``;
    ``return_order``: the return all_to_all's blocks concatenated in the
    reverse source order."""
    from repro_torch.models import blocks, mamba2, moe
    from repro_torch.train import step as step_lib

    saved = (blocks.wo_reduce, step_lib.data_mean, mamba2._conv_halo,
             mamba2._relay, sharding.seq_use, moe._a2a_return)
    if fault == "wo_without_reduce":
        calls = []

        def faulty(y, shard):
            calls.append(1)
            return y if len(calls) == 1 else saved[0](y, shard)

        blocks.wo_reduce = faulty
    elif fault == "grad_not_divided":
        step_lib.data_mean = lambda grads, shard: None
    elif fault == "no_halo":
        def halo(xbc, shard, width):
            prefix = saved[2](xbc, shard, width)
            return prefix * 0 if shard.tp_rank() == 1 else prefix

        mamba2._conv_halo = halo
    elif fault == "no_relay":
        mamba2._relay = lambda final, decay, shard: \
            saved[3](final, decay, shard) * 0
    elif fault in ("tp_grad_kept", "router_grad_kept"):
        leaf = "dt_bias" if fault == "tp_grad_kept" else "router"
        sharding.seq_use = lambda name, shard, stacked=True: (
            not name.endswith(leaf) and saved[4](name, shard, stacked))
    elif fault == "return_order":
        ret = saved[5]
        moe._a2a_return = lambda y, shard: ret(y, shard).flip(0)
    try:
        yield
    finally:
        (blocks.wo_reduce, step_lib.data_mean, mamba2._conv_halo,
         mamba2._relay, sharding.seq_use, moe._a2a_return) = saved


def fsdp_case(case: dict) -> dict:
    """fsdp_tp steps on (data 2, model 2): the metrics of each step, and
    after the last the gathered gradients, parameters and first moments,
    and this rank's stored shapes beside its placement's."""
    from repro_torch.models import model
    from repro_torch.train import step as step_lib

    cfg = case["cfg"]
    mesh = make_mesh(*FSDP_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg,
                                    global_batch=len(case["batch"]["targets"]),
                                    **case.get("posture", {}))
    lm = sharded_model(cfg, case["params"], shard)
    opt = AdamW(**case["opt"])
    state = opt.init(lm)
    accum = case.get("grad_accum", 1)
    batch = sharding.local_batch(
        {k: torch.from_numpy(v) for k, v in case["batch"].items()}, mesh,
        shard, accum)
    mets, booked = [], None
    with planted(case.get("fault")):
        step = step_lib.make_train_step(cfg, shard, opt, grad_accum=accum)
        for _ in range(case.get("steps", 1)):
            collectives.reset_stats()
            lm, state, met = step(lm, state, batch)
            booked = booked or {k: dict(v) for k, v in
                                collectives.STATS["by_kind"].items()}
            mets.append({k: float(v) for k, v in met.items()})
    full = dict(model.init_params(cfg, device="meta").named_parameters())
    want = {n: tuple(sharding.block(full[n], pl, mesh).shape)
            for n, pl in lm.placement.items()}
    got = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    out = {"metrics": mets, "shapes": (got, want), "collectives": booked,
           "local_bytes": sum(p.numel() * p.element_size()
                              for p in lm.parameters()),
           "grads": _full({n: p.grad for n, p in lm.named_parameters()},
                          lm.placement, mesh),
           "params": _full(dict(lm.named_parameters()), lm.placement, mesh),
           "m": _full(state.m, lm.placement, mesh)}
    if case.get("ckpt"):
        from repro_torch.ckpt.checkpointer import Checkpointer

        tree = {"params": dict(lm.named_parameters()), "opt": state}
        Checkpointer(case["ckpt"]).save(1, tree, shardings=sharding.named(
            {"params": lm.placement, "opt": AdamWState(
                step=(), m=lm.placement, v=lm.placement)}, mesh))
        torch.distributed.barrier()
        out["elastic"] = elastic_restore(cfg, case["ckpt"])
    return out


def elastic_restore(cfg, directory: str) -> dict:
    """The (data 2, model 2) snapshot restored at (data 4, model 1): this
    rank's blocks, its coordinate, and the tensors gathered back."""
    from repro_torch.ckpt.checkpointer import Checkpointer
    from repro_torch.models import model

    mesh = make_mesh((4, 1), ("data", "model"))
    shard = sharding.make_shard_cfg(mesh, cfg, global_batch=4)
    lm = sharding.shard_params(model.init_params(cfg, 1, device="cpu"), cfg,
                               shard)
    opt = AdamW()
    target = {"params": dict(lm.named_parameters()), "opt": opt.init(lm)}
    specs = {"params": lm.placement,
             "opt": AdamWState(step=(), m=lm.placement, v=lm.placement)}
    got = Checkpointer(directory).restore(
        1, target, shardings=sharding.named(specs, mesh))
    return {"coord": collectives.coordinate(mesh),
            "placement": lm.placement,
            "blocks": {n: _np(t) for n, t in got["params"].items()},
            "m_blocks": {n: _np(t) for n, t in got["opt"].m.items()},
            "full": _full(got["params"], lm.placement, mesh)}


def moe_tp_case(case: dict) -> dict:
    """``moe_apply`` of layer 0 under ``moe_mode="tp"`` on this rank's rows
    of x; the output gathered over the data axis."""
    from repro_torch.models import moe

    cfg = case["cfg"]
    mesh = make_mesh(*FSDP_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg, global_batch=len(case["x"]))
    assert shard.moe_mode == "tp"
    lm = sharded_model(cfg, case["params"], shard)
    x = sharding.block(torch.from_numpy(case["x"]), ("data", None, None),
                       mesh)
    with torch.no_grad(), sharding.using(lm,
                                         sharding.gather_params(lm, shard)):
        out, met = moe.moe_apply(lm.stack.layers[0].ffn, cfg, x, shard)
    return {"out": _np(collectives.all_gather(out, mesh, "data", 0)),
            "dropped": float(met.dropped_frac)}


def sp_forward_case(case: dict) -> dict:
    """The sequence-parallel forwards on (data 2, model 2) from the numpy
    tree, on this rank's rows of each seeded x (gathered back over
    ``data``): ``mamba2_seq`` of layer 0 under ``ssm_sp`` at each S of
    ``case["ssm"]``, and ``moe_apply`` of layer 0 under ``a2a`` at each
    capacity factor of ``case["moe"]`` with its metrics."""
    import dataclasses

    from repro_torch.models import mamba2, moe

    mesh = make_mesh(*FSDP_MESH)
    out = {"coord": collectives.coordinate(mesh), "ssm": {}, "moe": {}}
    cfg = case["ssm_cfg"]
    shard = sharding.make_shard_cfg(mesh, cfg, 4, ssm_sp=True)
    lm = sharded_model(cfg, case["ssm_params"], shard)
    for s, x in case["ssm"].items():
        x = sharding.block(torch.from_numpy(x), ("data", None, None), mesh)
        with torch.no_grad(), sharding.using(
                lm, sharding.gather_params(lm, shard,
                                           within="stack.layers.0.")):
            y, _ = mamba2.mamba2_seq(lm.stack.layers[0].mamba, cfg, x, shard)
        out["ssm"][s] = _np(collectives.all_gather(y, mesh, "data", 0))
    for cf, x in case["moe"].items():
        cfg = dataclasses.replace(case["moe_cfg"], capacity_factor=cf)
        shard = sharding.make_shard_cfg(mesh, cfg, 4, moe_mode="a2a")
        lm = sharded_model(cfg, case["moe_params"], shard)
        x = sharding.block(torch.from_numpy(x), ("data", None, None), mesh)
        with torch.no_grad(), sharding.using(
                lm, sharding.gather_params(lm, shard,
                                           within="stack.layers.0.")):
            y, met = moe.moe_apply(lm.stack.layers[0].ffn, cfg, x, shard)
        out["moe"][cf] = {
            "out": _np(collectives.all_gather(y, mesh, "data", 0)),
            **{k: float(v) for k, v in met._asdict().items()}}
    return out


def step_gradient(opt, m_now: dict, m_before: dict, clip_scale) -> dict:
    """The gradient an AdamW step took, read back from its first moments:
    m_t = b1 · m_(t-1) + (1 - b1) · s_t · g_t, s_t the step's clip scale."""
    return {n: _np((m - opt.b1 * m_before[n])
                   / ((1 - opt.b1) * float(clip_scale)))
            for n, m in m_now.items()}


def dp_case(case: dict) -> dict:
    """The dp step on (pod 2, data 2), exact and with int8 error feedback
    across pods, ``steps`` steps each from the same start; each rank takes
    its row of the 4-row batch.  After each step: the metrics, the
    parameters, the parameters' ``.grad``, the gradient the update took
    (:func:`step_gradient`) and (compressed) this rank's residual; and the
    compressed second step given no residual (its parameters, the gradient
    it took and its residual)."""
    from repro_torch.train import step as step_lib

    cfg = case["cfg"]
    mesh = make_mesh(*DP_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg, global_batch=4, mode="dp")
    batch = sharding.local_batch(
        {k: torch.from_numpy(v) for k, v in case["batch"].items()}, mesh,
        shard)
    out = {}
    for compress in (False, True):
        lm = convert.lm_params_from_numpy(cfg, case["params"], device="cpu")
        opt = AdamW(**case["opt"])
        state = opt.init(lm)
        step = step_lib._make_dp_train_step(cfg, shard, opt,
                                            compress_pod_grads=compress)
        mets, params, grads, took, ef, err = [], [], [], [], [], None
        for i in range(case["steps"]):
            m_before = {n: m.clone() for n, m in state.m.items()}
            if compress and i == 1:     # the same step given no residual
                twin = copy.deepcopy((lm, state))
                tlm, tstate, tmet = step(*twin, batch, None)
                out["uncarried"] = {
                    "params": {n: _np(p) for n, p in tlm.named_parameters()},
                    "took": step_gradient(opt, tstate.m, m_before,
                                          tmet["clip_scale"]),
                    "ef": {n: _np(e) for n, e in tmet["ef_err"].items()}}
            if compress:
                lm, state, met = step(lm, state, batch, err)
                err = met.pop("ef_err")
                ef.append({n: _np(e) for n, e in err.items()})
            else:
                lm, state, met = step(lm, state, batch)
            mets.append({k: float(v) for k, v in met.items()})
            params.append({n: _np(p) for n, p in lm.named_parameters()})
            grads.append({n: _np(p.grad) for n, p in lm.named_parameters()})
            took.append(step_gradient(opt, state.m, m_before,
                                      met["clip_scale"]))
        out["compressed" if compress else "exact"] = {
            "metrics": mets, "params": params, "grads": grads,
            "took": took, "ef": ef}
    return out


def ef_case(cases: list) -> dict:
    """``ef_allreduce_mean`` over the ``pod`` axis of (pod 2, data 2):
    each rank's pod index picks its (g, err) of every case."""
    from repro_torch.dist.compression import ef_allreduce_mean

    mesh = make_mesh(*DP_MESH)
    pod = collectives.coordinate(mesh)["pod"]
    res = []
    for g, e in cases:
        gm, ne = ef_allreduce_mean(torch.from_numpy(g[pod]),
                                   torch.from_numpy(e[pod]), mesh, "pod")
        res.append((_np(gm), _np(ne)))
    return {"pod": pod, "results": res}


def gpipe_case(case: dict) -> np.ndarray:
    """``gpipe_forward`` over ``pod`` 4 of the toy stack tanh(h @ w)."""
    from repro_torch.dist.pipeline_parallel import gpipe_forward, stage_params

    mesh = make_mesh((4,), ("pod",))
    ws = torch.from_numpy(case["ws"])
    ws = sharding.block(ws, stage_params(ws, mesh), mesh)
    out = gpipe_forward(case["cfg"], mesh, lambda w, h: torch.tanh(h @ w),
                        ws, torch.from_numpy(case["x"]),
                        n_microbatch=case["microbatches"])
    return _np(out)


def bf16_case(seed: int) -> dict:
    """The collectives on bfloat16 blocks over ``data`` (gloo takes no
    16-bit integers: a gather moves the bytes): this rank's seeded block,
    the gather, and the gather's backward (the reduce-scatter of a seeded
    gradient, summed in float32 and rounded once)."""
    mesh = make_mesh(*FSDP_MESH)
    me = collectives.coordinate(mesh)["data"]
    gen = torch.Generator().manual_seed(seed)
    blocks = torch.randn((2, 3, 5), generator=gen).to(torch.bfloat16)
    grad = torch.randn((3, 10), generator=gen).to(torch.bfloat16)
    x = blocks[me].clone().requires_grad_(True)
    y = collectives.gather(x, mesh, "data", 1)
    y.backward(grad * (me + 1))
    return {"data": me, "gathered": _np(y), "grad": _np(x.grad),
            "dtypes": (str(y.dtype), str(x.grad.dtype))}


def gather_many_case(seed: int) -> dict:
    """Two float32 blocks over ``data`` in one collective, along dims 0 and
    1: the gathers and, with the gradient summed back and with this rank's
    block kept, the blocks' gradients of seeded whole gradients scaled by
    (data index + 1)."""
    mesh = make_mesh(*FSDP_MESH)
    me = collectives.coordinate(mesh)["data"]
    gen = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(s, generator=gen) for s in ((2, 2, 3), (2, 3, 4)))
    ga, gb = (torch.randn(s, generator=gen) for s in ((4, 3), (3, 8)))
    out = {"data": me}
    for back in (True, False):
        x, y = (t[me].clone().requires_grad_(True) for t in (a, b))
        wx, wy = collectives.gather_many([x, y], mesh, "data", [0, 1],
                                         reduce_back=back)
        torch.autograd.backward([wx, wy], [ga * (me + 1), gb * (me + 1)])
        out[back] = {"x": _np(wx), "y": _np(wy), "gx": _np(x.grad),
                     "gy": _np(y.grad)}
    return out


def launcher_case(argv: list) -> list:
    """``launch.train``'s run over a (2, 2) mesh in these ranks (the ranks
    ``--mesh 2x2`` would start)."""
    from repro_torch.launch import train

    args = train.parser().parse_args(argv)
    return train.train(args, train.mesh_shape(args.mesh,
                                              torch.device("cpu")))


@contextlib.contextmanager
def serve_planted(fault: str | None):
    """A fault of the meshed decode: ``unweighted``: the ranks' partials
    averaged without their log-sum-exp weights; ``every_rank``: the new
    token's k and v written on every ``tp`` rank (at the nearest position
    of a block that does not hold it); ``nan_empty``: a block that holds
    no valid key of a row reports NaN and an lse of -inf there, as a
    decode dividing by its empty sum would."""
    from repro_torch.kernels.attention import block_valid_len
    from repro_torch.models import blocks

    saved = (blocks.merge_partials, blocks.kv_owner,
             blocks.decode_mha_partial)
    if fault == "unweighted":
        blocks.merge_partials = lambda outs, lses: outs.float().mean(0).to(
            outs.dtype)
    elif fault == "every_rank":
        blocks.kv_owner = lambda pos, kv_block, size: (
            torch.ones_like(pos, dtype=torch.bool) if torch.is_tensor(pos)
            else True)
    elif fault == "nan_empty":
        def partial(q, k, v, cache_len, start, **kw):
            out, lse = saved[2](q, k, v, cache_len, start, **kw)
            empty = (block_valid_len(cache_len, start, k.shape[1])
                     == 0).reshape(-1, 1, 1)
            return (torch.where(empty[..., None], float("nan"), out),
                    torch.where(empty, -float("inf"), lse))

        blocks.decode_mha_partial = partial
    try:
        yield
    finally:
        (blocks.merge_partials, blocks.kv_owner,
         blocks.decode_mha_partial) = saved


def a2a_case(seed: int) -> dict:
    """``collectives.all_to_all`` over ``model`` of this rank's seeded
    bfloat16 block (gloo moves its bytes): split along dim 1, the received
    blocks concatenated along dim 2."""
    mesh = make_mesh(*FSDP_MESH)
    me = torch.distributed.get_rank()
    gen = torch.Generator().manual_seed(seed + me)
    x = torch.randn((3, 4, 5), generator=gen).to(torch.bfloat16)
    y = collectives.all_to_all(x, mesh, "model", 1, 2)
    return {"x": _np(x), "y": _np(y), "dtype": str(y.dtype),
            "coord": collectives.coordinate(mesh)}


def serve_case(case: dict) -> dict:
    """The meshed prefill and decode steps on (data 2, model 2): the
    model's blocks from the numpy tree (``shard_params``), the caches'
    blocks (``local_caches``); this rank's rows of the batch, of each
    step's tokens and per-row lengths.  Returns the gathered logits of the
    prefill and of each step, this rank's cache blocks (numpy leaves in
    order) and its coordinate."""
    from repro_torch.models import model

    cfg = case["cfg"]
    mesh = make_mesh(*FSDP_MESH)
    b = len(case["lens"])
    shard = sharding.make_shard_cfg(mesh, cfg, global_batch=b)
    lm = sharded_model(cfg, case["params"], shard)
    caches, kvb = sharding.local_caches(cfg, b, case["max_seq"], shard,
                                        torch.float32, "cpu")
    rows = sharding.local_rows(b, shard)
    batch = {k: torch.from_numpy(v)[rows] for k, v in case["batch"].items()}
    lens = torch.from_numpy(case["lens"])[rows]
    with serve_planted(case.get("fault")):
        logits, caches = model.prefill(lm, cfg, batch, caches, shard,
                                       kv_block=kvb)
        out = [_np(logits)]
        for i, tok in enumerate(case["tokens"]):
            logits, caches = model.decode_step(
                lm, cfg, torch.from_numpy(tok)[rows], caches, lens + i,
                shard, kv_block=kvb)
            out.append(_np(logits))
    return {"logits": out, "coord": collectives.coordinate(mesh),
            "kv_block": kvb,
            "caches": [_np(t) for t in sharding.tree_leaves(caches)]}


def engine_case(case: dict) -> dict:
    """``ServingEngine(shard=make_shard_cfg(mesh, cfg, slots))`` over
    (data 2, model 2) on the whole model: the requests' tokens, the steps
    and this rank's cache shapes."""
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = case["cfg"]
    mesh = make_mesh(*FSDP_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg, case["slots"])
    lm = convert.lm_params_from_numpy(cfg, case["params"], device="cpu")
    eng = ServingEngine(cfg, lm, slots=case["slots"],
                        max_seq=case["max_seq"], shard=shard, device="cpu")
    for i, p in enumerate(case["prompts"]):
        eng.submit(Request(i, p, max_new_tokens=case["new"]))
    done = {r.rid: r.output for r in eng.run_until_drained()}
    return {"tokens": done, "steps": eng.steps, "idle": eng.table.idle,
            "rows": (eng.rows.start, eng.rows.stop),
            "kv_block": eng.kv_block,
            "cache_shapes": [tuple(t.shape) for t in
                             sharding.tree_leaves(eng.caches)]}


def all_jobs(jobs: dict) -> dict:
    """Every job of the test file, in one launch."""
    out = {}
    for name, case in jobs.items():
        kind = case["kind"]
        out[name] = {"fsdp": fsdp_case, "moe_tp": moe_tp_case,
                     "dp": dp_case, "ef": ef_case, "gpipe": gpipe_case,
                     "launcher": launcher_case, "bf16": bf16_case,
                     "gather_many": gather_many_case, "serve": serve_case,
                     "a2a": a2a_case, "sp_forward": sp_forward_case,
                     "engine": engine_case}[kind](case["case"])
    return out
