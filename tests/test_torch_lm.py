"""The port's language-model serving slice against the JAX reference, on
the CPU: configs, parameters carried across by ``lm_params_from_numpy``,
prefill logits and caches, per-slot decode steps, and the continuous-
batching ``ServingEngine`` (the same greedy tokens per request), for every
family: hybrid, dense, moe, ssm, audio and vlm (zamba2-1.2b; llama3-8b,
qwen1.5-4b, minitron-4b and granite-8b; qwen3-moe-235b-a22b and
kimi-k2-1t-a32b; xlstm-125m; musicgen-large; paligemma-3b).  The moe engine's bucket pads are routed like any token and
count toward the expert capacity, as in the reference; the ssm family's
states absorb the pads and the re-decoded token, as zamba2's do.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.serve import engine as rengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import mamba2, model, moe  # noqa: E402
from repro_torch.models.config import ShardCfg  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ARCHS = ("zamba2-1.2b", "llama3-8b", "qwen3-moe-235b-a22b",
         "kimi-k2-1t-a32b", "xlstm-125m", "qwen1.5-4b", "minitron-4b",
         "granite-8b", "musicgen-large", "paligemma-3b")
# float32 smoke models: the packages differ in summation order only; 2e-5
# of the logits' scale (~3) covers two layers' and a decode step's worth.
TOL = 2e-5
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(arch, seed=0):
    rcfg = rreg.smoke(rreg.get_config(arch))
    cfg = registry.smoke(registry.get_config(arch))
    rp = rmodel.init_params(rcfg, jax.random.PRNGKey(seed))
    lm = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp),
                                      device="cpu")
    return rcfg, cfg, rp, lm


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, TOL * scale)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_reference_field_for_field(arch, reduced):
    rcfg, cfg = rreg.get_config(arch), registry.get_config(arch)
    if reduced:
        rcfg, cfg = rreg.smoke(rcfg), registry.smoke(cfg)
    for f in dataclasses.fields(rcfg):
        a, b = getattr(rcfg, f.name), getattr(cfg, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert _DT[a] == b, f.name
        else:
            assert a == b, f.name
    for prop in ("d_inner", "ssm_heads", "conv_dim"):
        assert getattr(rcfg, prop) == getattr(cfg, prop)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_the_reference(arch):
    """The port's model at published widths has the reference's parameter
    count (counted on the meta device, nothing allocated)."""
    assert registry.get_config(arch).param_count() == \
        rreg.get_config(arch).param_count()


def test_other_architectures_and_postures_are_not_ported():
    """Every arch of the reference is ported (the audio and vlm families
    last); serving over a mesh builds its engine (on a stub mesh here;
    the mesh postures are ``tests/test_torch_sharded.py``'s and
    ``tests/test_torch_sharded_serve.py``'s).  Sequence-parallel Mamba2
    and ``moe_mode="a2a"`` serve as the reference's do, so what raises is
    what the reference cannot run either: a prefill that fills the Mamba2
    caches under ``ssm_sp``, and a decode step's one token under ``a2a``
    (``ValueError``, on a counting mesh: no ranks)."""
    assert registry.list_archs() == rreg.list_archs()
    assert set(registry.list_archs()) == set(ARCHS)
    with pytest.raises(KeyError):
        registry.get_config("gpt-2")
    small = registry.smoke(registry.get_config("llama3-8b"))
    at = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                               shape=(2, 2), get_coordinate=lambda: [0, 1])
    eng = engine.ServingEngine(small, model.init_params(small, 0,
                                                        device="cpu"),
                               shard=ShardCfg(mesh=at, moe_mode="local"),
                               slots=4, max_seq=32, device="cpu")
    assert tuple(eng.caches.k.shape[1:3]) == (2, 16)
    assert tuple(eng.kv_block) == (16, True)
    from repro_torch.launch.mesh import CountingMesh

    mesh = CountingMesh((2, 2), ("data", "model"))
    zamba = registry.smoke(registry.get_config("zamba2-1.2b"))
    with pytest.raises(ValueError, match="returns no state"):
        mamba2.mamba2_seq(model.init_params(zamba, 0, device="cpu")
                          .stack.layers[0].mamba, zamba,
                          torch.zeros((2, 32, zamba.d_model)),
                          ShardCfg(mesh=mesh, ssm_sp=True), return_state=True)
    qwen = registry.smoke(registry.get_config("qwen3-moe-235b-a22b"))
    with pytest.raises(ValueError, match="one token cannot split"):
        moe.moe_apply(model.init_params(qwen, 0, device="cpu")
                      .stack.layers[0].ffn, qwen,
                      torch.zeros((2, 1, qwen.d_model)),
                      ShardCfg(mesh=mesh, moe_mode="a2a"))
    # a dense config relabelled audio builds the dense stack, as the
    # reference's does
    audio = dataclasses.replace(
        registry.smoke(registry.get_config("llama3-8b")), family="audio")
    dense = model.init_params(
        registry.smoke(registry.get_config("llama3-8b")), 0, device="cpu")
    got = model.init_params(audio, 0, device="cpu").state_dict()
    assert got.keys() == dense.state_dict().keys()
    assert all(torch.equal(got[k], v) for k, v in dense.state_dict().items())
    # prefix_embeds in prefill: a bidirectional prefix before the tokens,
    # whose rows fill the cache's first positions
    _, cfg, _, lm = _pair("llama3-8b")
    caches = model.init_caches(cfg, 1, 8, torch.float32, "cpu")
    pre = torch.randn(1, 2, 128, generator=torch.Generator().manual_seed(0))
    logits, caches = model.prefill(
        lm, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                  "prefix_embeds": pre}, caches)
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert bool((caches.k[:, :, :6] != 0).any(dim=-1).all())
    assert not bool(caches.k[:, :, 6:].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree_and_distributions(arch):
    rcfg, cfg, rp, _ = _pair(arch)
    lm = model.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    ref = {".".join(k): np.asarray(v) for k, v in
           convert._flatten(jax.tree.map(np.asarray, rp))}
    got = lm.state_dict()
    # the reference stacks the layers' leaves along a leading axis, but the
    # ssm family's, a tuple of per-layer trees named by their index
    stacked = ({k for k in ref if k.startswith("stack.layers.")}
               if lm.stack.stacked else set())
    for k in stacked:
        for i in range(cfg.num_layers):
            name = k.replace("stack.layers.", f"stack.layers.{i}.", 1)
            assert tuple(got.pop(name).shape) == ref[k].shape[1:], name
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: ref[k].shape for k in ref if k not in stacked}
    table = lm.embed.table
    assert float(table.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) * (1 + 1e-6)
    assert abs(float(table.std()) * np.sqrt(cfg.d_model) - 0.88) < 0.03
    again = model.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(lm.state_dict().values(), again.state_dict().values()))


def test_params_convert_bitwise():
    rcfg, cfg, rp, lm = _pair("zamba2-1.2b")
    ref = dict(convert._flatten(jax.tree.map(np.asarray, rp)))
    got = lm.state_dict()
    assert np.array_equal(got["stack.layers.1.mamba.in_proj.w"].numpy(),
                          ref[("stack", "layers", "mamba", "in_proj", "w")][1])
    assert np.array_equal(got["stack.shared_attn.attn.wq"].numpy(),
                          ref[("stack", "shared_attn", "attn", "wq")])
    bf = np.asarray(jnp.asarray(ref[("embed", "table")], jnp.bfloat16))
    t = convert._tensor(bf)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), bf.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_per_slot_decode_match_reference(arch):
    rcfg, cfg, rp, lm = _pair(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 40))
    rc = rmodel.init_caches(rcfg, 2, 64, jnp.float32)
    rl, rc = rmodel.prefill(rp, rcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                            rc, rmodel.LOCAL)
    pc = model.init_caches(cfg, 2, 64, torch.float32, "cpu")
    pl, pc = model.prefill(lm, cfg, {"tokens": torch.from_numpy(toks)}, pc)
    _close(pl, rl, "prefill logits")
    got = convert.caches_to_numpy(pc)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, rc)),
                    jax.tree.leaves(got)):
        _close(b, a, "prefill caches")
    # caches round-trip through numpy both ways
    back = convert.caches_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    assert jax.tree.structure(convert.caches_to_numpy(back)) == \
        jax.tree.structure(got)
    lens = np.array([40, 17])
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1))
        rl, rc = rmodel.decode_step(rp, rcfg, jnp.asarray(tok, jnp.int32), rc,
                                    jnp.asarray(lens, jnp.int32))
        pl, pc = model.decode_step(lm, cfg, torch.from_numpy(tok), pc,
                                   torch.from_numpy(lens))
        _close(pl, rl, f"decode {step}")
        lens = lens + 1
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, rc)),
                    jax.tree.leaves(convert.caches_to_numpy(pc))):
        _close(b, a, "decoded caches")
    # a uniform-batch (scalar) decode step
    tok = rng.integers(0, cfg.vocab_size, size=(2, 1))
    rl, _ = rmodel.decode_step(rp, rcfg, jnp.asarray(tok, jnp.int32), rc, 45)
    pl, _ = model.decode_step(lm, cfg, torch.from_numpy(tok), pc, 45)
    _close(pl, rl, "scalar decode")


# prompt lengths: 5 and 20 are padded up to their bucket (32), 32 fills it,
# 33 and 47 pad to 64; five requests through two slots reuse both slots
PROMPTS = (5, 32, 33, 20, 47)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_tokens_equal_the_reference_per_request(arch):
    """Greedy tokens per request equal the reference engine's, bitwise
    lists.  zamba2's prompts with pad tokens in their bucket exercise the
    reference's bucket-padding behaviour (its Mamba states absorb the pads
    and the re-decoded last token), which the port reproduces."""
    rcfg, cfg, rp, lm = _pair(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in PROMPTS]
    ref = rengine.ServingEngine(rcfg, rp, slots=2, max_seq=96)
    port = engine.ServingEngine(cfg, lm, slots=2, max_seq=96, device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(rengine.Request(i, p.astype(np.int32), max_new_tokens=6))
        port.submit(engine.Request(i, p, max_new_tokens=6))
    want = {r.rid: r.output for r in ref.run_until_drained()}
    got = {r.rid: r.output for r in port.run_until_drained()}
    assert got == want
    assert port.steps == ref.steps and port.table.idle


def test_zamba2_tokens_depend_on_the_bucket_as_in_the_reference():
    """The hybrid family's bucket-pad fault is reproduced, not repaired: a
    5-token prompt served through the engine (padded to 32, last token
    re-decoded) does not give the tokens of an unpadded prefill."""
    _, cfg, _, lm = _pair("zamba2-1.2b")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=5)
    eng = engine.ServingEngine(cfg, lm, slots=1, max_seq=64, device="cpu")
    eng.submit(engine.Request(0, prompt, max_new_tokens=1))
    served = eng.run_until_drained()[0].output[0]
    caches = model.init_caches(cfg, 1, 64, torch.float32, "cpu")
    logits, _ = model.prefill(lm, cfg, {"tokens": torch.from_numpy(prompt)[None]},
                              caches)
    assert int(logits[0, -1].argmax()) != served


def test_engine_device_and_backend():
    _, cfg, _, lm = _pair("llama3-8b")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        engine.ServingEngine(cfg, lm, device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        engine.ServingEngine(cfg, lm, device="cpu", backend="pallas")
    assert engine.ServingEngine(cfg, lm, device="cpu").template == "TORCH"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            engine.ServingEngine(cfg, lm)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_the_smoke_model_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
