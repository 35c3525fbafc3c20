"""The port's ``audio`` and ``vlm`` families against the JAX reference, on
the CPU: musicgen-large (stub frame embeddings in place of the tokens) and
paligemma-3b (stub patch embeddings as a bidirectional prefix, 8 query
heads of 256 over one kv head), at the smoke configs (2 layers, float32,
``num_prefix_tokens`` 8).

Both packages get the same weights (``convert.lm_params_from_numpy``) and
the same seeded numpy embeddings: jax's threefry stream, which the
reference's stubs draw from, is not reproduced, so the port's own stubs
(``models.multimodal``) are held to shape, dtype, scale and determinism.
FLASH_ATTENTION's plain version is held to the reference at head dim 256,
MQA 8:1, with the bidirectional prefix; the kernel itself on the card
(``tests/test_torch_cuda.py -k d256``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.dist.sharding import _path_str  # noqa: E402
from repro.kernels.attention import flash_attention as r_flash  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro.models.config import LOCAL as RLOCAL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import attention_cuda, ref  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import layers, model, multimodal  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import LOCAL  # noqa: E402

ARCHS = ("musicgen-large", "paligemma-3b")
B, S, K = 2, 24, 3
# float32 smoke models: the packages differ in summation order only (as
# tests/test_torch_lm.py's TOL): 2e-5 of the logits' scale
TOL = 2e-5
# prefill + K decode steps against one full pass, as the reference's own
# tests/test_models.py holds it
CONSISTENCY_TOL = 2e-2
LOSS_RTOL = 1e-5          # the loss, as tests/test_torch_train.py
GRAD_TOL = 1e-4           # per leaf: max|port - ref| <= GRAD_TOL * max|ref|
# attention: float32 outputs at 2e-6 of their scale, bf16 at one bf16 ulp
# (2^-7), as tests/test_torch_attention.py
F32_TOL, BF16_TOL = 2e-6, 2.0 ** -7
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(arch, seed=0, dtype=torch.float32):
    rcfg = rreg.smoke(rreg.get_config(arch))
    cfg = registry.smoke(registry.get_config(arch))
    if dtype != torch.float32:
        rcfg = dataclasses.replace(rcfg, compute_dtype=_JDT[dtype])
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    rp = rmodel.init_params(rcfg, jax.random.PRNGKey(seed))
    lm = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp),
                                      device="cpu")
    return rcfg, cfg, rp, lm


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


def _inputs(cfg, seq, seed=0, tokens=None):
    """numpy inputs of the family: musicgen's frame embeddings in place of
    the tokens; paligemma's patch embeddings before its tokens."""
    rng = np.random.default_rng(seed)
    emb = lambda n: (rng.standard_normal((B, n, cfg.d_model))
                     / np.sqrt(cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        return {"embeds": emb(seq)}
    toks = (rng.integers(0, cfg.vocab_size, size=(B, seq))
            if tokens is None else tokens)
    return {"tokens": toks.astype(np.int32),
            "prefix_embeds": emb(cfg.num_prefix_tokens)}


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the input embedding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inputs", ["embeds", "prefix_embeds", "both"])
def test_embed_inputs_equal_the_reference_bitwise(inputs, dtype):
    """``embed_inputs`` only moves data (a gather, a cast, a concatenation):
    the port's equals the reference's bit for bit, with the same
    ``prefix_len``."""
    arch = "musicgen-large" if inputs == "embeds" else "paligemma-3b"
    rcfg, cfg, rp, lm = _pair(arch, dtype=dtype)
    batch = _inputs(cfg, S)
    if inputs == "both":
        batch["embeds"] = _inputs(registry.smoke(
            registry.get_config("musicgen-large")), S, seed=1)["embeds"]
    rx, rpre = rmodel.embed_inputs(rp, rcfg, _ref_batch(batch), RLOCAL)
    x, pre = model.embed_inputs(lm, cfg, _port_batch(batch), LOCAL)
    assert pre == rpre == (cfg.num_prefix_tokens if "prefix_embeds" in batch
                           else 0)
    assert x.dtype == dtype and tuple(x.shape) == rx.shape
    assert np.array_equal(x.float().numpy(),
                          np.asarray(rx.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _full_logits(lm, cfg, batch):
    """One pass over the whole sequence: the logits at every position."""
    x, prefix_len = model.embed_inputs(lm, cfg, batch, LOCAL)
    x, _, _ = transformer.stack_seq(
        lm.stack, cfg, x, LOCAL, positions=torch.arange(x.shape[1]),
        mask=pattn.MaskSpec(True, prefix_len=prefix_len), mode="train")
    x = layers.rmsnorm(lm.final_norm, x, cfg.norm_eps)
    return x @ model._unembed_w(lm, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_one_full_pass(arch):
    """The reference's decode consistency (tests/test_models.py), through
    the stub inputs: musicgen prefills S frame embeddings and decodes K
    codebook tokens, against one pass over the S frames and the K tokens'
    embeddings; paligemma prefills its patch prefix and S tokens, then
    decodes K tokens, against one pass over the prefix and S + K tokens."""
    _, cfg, _, lm = _pair(arch)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S + K)))
    batch = _port_batch(_inputs(cfg, S, tokens=toks.numpy()))
    with torch.no_grad():
        if cfg.family == "audio":
            tail = layers.embed(lm.embed, toks[:, S:], cfg.compute_dtype)
            full = {"embeds": torch.cat([batch["embeds"], tail], dim=1)}
            pre = batch
        else:
            full = dict(batch)
            pre = {"tokens": toks[:, :S],
                   "prefix_embeds": batch["prefix_embeds"]}
        prefix = cfg.num_prefix_tokens if "prefix_embeds" in full else 0
        want = _full_logits(lm, cfg, full)
        caches = model.init_caches(cfg, B, prefix + S + K + 2, torch.float32,
                                   "cpu")
        lg, caches = model.prefill(lm, cfg, pre, caches)
        errs = [float((lg[:, 0] - want[:, prefix + S - 1]).abs().max())]
        for i in range(K):
            lg, caches = model.decode_step(lm, cfg, toks[:, S + i][:, None],
                                           caches, prefix + S + i)
            errs.append(float((lg[:, 0] - want[:, prefix + S + i])
                              .abs().max()))
    assert max(errs) < CONSISTENCY_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_the_reference(arch):
    """The stub inputs prefilled, then K per-slot decode steps: logits and
    caches against the reference's at TOL."""
    rcfg, cfg, rp, lm = _pair(arch)
    batch = _inputs(cfg, S, seed=3)
    prefix = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    rc = rmodel.init_caches(rcfg, B, 64, jnp.float32)
    rl, rc = rmodel.prefill(rp, rcfg, _ref_batch(batch), rc, RLOCAL)
    pc = model.init_caches(cfg, B, 64, torch.float32, "cpu")
    pl, pc = model.prefill(lm, cfg, _port_batch(batch), pc)
    _close(pl, rl, TOL, "prefill logits")
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, rc)),
                    jax.tree.leaves(convert.caches_to_numpy(pc))):
        _close(b, a, TOL, "prefill caches")
    rng = np.random.default_rng(4)
    lens = np.array([prefix + S, prefix + S - 5])
    for step in range(K):
        tok = rng.integers(0, cfg.vocab_size, size=(B, 1))
        rl, rc = rmodel.decode_step(rp, rcfg, jnp.asarray(tok, jnp.int32), rc,
                                    jnp.asarray(lens, jnp.int32))
        pl, pc = model.decode_step(lm, cfg, torch.from_numpy(tok), pc,
                                   torch.from_numpy(lens))
        _close(pl, rl, TOL, f"decode {step}")
        lens = lens + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    """``loss_fn`` with ``embeds`` (musicgen) and with ``prefix_embeds``
    (paligemma: the loss over the text after the prefix) against
    ``jax.value_and_grad``: the loss, every parameter's gradient and the
    gradient of the stub embeddings themselves."""
    rcfg, cfg, rp, lm = _pair(arch)
    batch = _inputs(cfg, S, seed=5)
    rng = np.random.default_rng(6)
    targets = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    targets[0, :3] = -1                           # masked targets
    stub = "embeds" if cfg.family == "audio" else "prefix_embeds"

    def rloss(p, e):
        b = dict(_ref_batch(batch), targets=jnp.asarray(targets))
        b[stub] = e
        return rmodel.loss_fn(p, rcfg, b, RLOCAL)

    (want, rmet), (rgrads, rgrad_e) = jax.value_and_grad(
        rloss, argnums=(0, 1), has_aux=True)(rp, jnp.asarray(batch[stub]))
    lm.requires_grad_(True)
    pb = _port_batch(batch)
    pb[stub] = pb[stub].clone().requires_grad_(True)
    pb["targets"] = torch.from_numpy(targets.astype(np.int64))
    loss, met = model.loss_fn(lm, cfg, pb)
    loss.backward()
    # with embeds in place of the tokens the embedding table is not
    # reached: no gradient in torch, zeros from jax (the train step fills
    # them in, as jax gives them)
    unreached = [n for n, p in lm.named_parameters() if p.grad is None]
    assert unreached == (["embed.table"] if stub == "embeds" else [])
    for n in unreached:
        lm.get_parameter(n).grad = torch.zeros_like(lm.get_parameter(n))
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["acc"]), float(rmet["acc"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    got = convert.grads_to_numpy(lm)
    ref_tree = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(ref_tree)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(ref_tree)[0],
                            jax.tree.leaves(got)):
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (_path_str(path), err)
    w = np.asarray(rgrad_e)
    assert float(np.abs(w).max()) > 0
    err = float(np.abs(pb[stub].grad.numpy() - w).max())
    assert err <= GRAD_TOL * float(np.abs(w).max()), (stub, err)


def test_the_loss_scores_only_the_text_after_the_prefix():
    """paligemma's loss takes the hidden states after the prefix: with
    ``S`` targets for ``S`` tokens it equals the chunked cross-entropy of
    the last ``S`` positions of the full pass."""
    _, cfg, _, lm = _pair("paligemma-3b")
    batch = _port_batch(_inputs(cfg, S, seed=8))
    targets = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(B, S)))
    with torch.no_grad():
        loss, _ = model.loss_fn(lm, cfg, dict(batch, targets=targets))
        x, prefix_len = model.embed_inputs(lm, cfg, batch, LOCAL)
        x, _, _ = transformer.stack_seq(
            lm.stack, cfg, x, LOCAL, positions=torch.arange(x.shape[1]),
            mask=pattn.MaskSpec(True, prefix_len=prefix_len), mode="train")
        x = layers.rmsnorm(lm.final_norm, x, cfg.norm_eps)
        want, _ = model.chunked_xent(lm, cfg, x[:, prefix_len:], targets)
    assert prefix_len == cfg.num_prefix_tokens == 8
    assert torch.equal(loss, want)


def _leaf_rel(got, want) -> float:
    """The largest relative L2 error over the leaves of two trees."""
    return max(float(np.linalg.norm(np.asarray(g, np.float64)
                                    - np.asarray(w, np.float64))
                     / max(np.linalg.norm(np.asarray(w, np.float64)), 1e-30))
               for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_match_the_reference(arch):
    """Two AdamW train steps on the stub inputs through
    ``train.step.make_train_step`` against the reference's: the loss and
    grad norm of each step, then every parameter at 1e-3 relative L2 (as
    tests/test_torch_train.py; Adam divides each gradient by its own
    running magnitude).  musicgen's embedding table, which ``embeds``
    bypass, gets jax's zero gradient, so it is decayed alike."""
    from repro.optim import adamw as radamw
    from repro.train import step as rstep
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as step_lib

    rcfg, cfg, rp, lm = _pair(arch)
    rts = rstep.make_train_step(rcfg, RLOCAL, radamw.AdamW(lr=1e-2))
    ts = step_lib.make_train_step(cfg, LOCAL, AdamW(lr=1e-2))
    rst, st = radamw.AdamW(lr=1e-2).init(rp), AdamW(lr=1e-2).init(lm)
    table = lm.embed.table.detach().clone()
    for step in range(2):
        batch = _inputs(cfg, S, seed=10 + step)
        rng = np.random.default_rng(20 + step)
        batch["targets"] = rng.integers(0, cfg.vocab_size,
                                        size=(B, S)).astype(np.int32)
        rp, rst, rmet = rts(rp, rst, _ref_batch(batch))
        lm, st, met = ts(lm, st, _port_batch(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    assert _leaf_rel(convert.lm_params_to_numpy(lm),
                     jax.tree.map(np.asarray, rp)) <= 1e-3
    assert not torch.equal(lm.embed.table.detach(), table)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_convert_both_ways_bitwise(arch):
    """``lm_params_from_numpy`` carries each arch's tree across and back
    bit for bit: the dense stack's leaves, paligemma's tied embedding (no
    ``unembed``), musicgen's own unembedding."""
    _, cfg, rp, lm = _pair(arch)
    want = jax.tree.map(np.asarray, rp)
    got = convert.lm_params_to_numpy(lm)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    assert ("unembed" in want) == (not cfg.tie_embeddings)
    assert cfg.tie_embeddings == (arch == "paligemma-3b")


# ---------------------------------------------------------------------------
# FLASH_ATTENTION's plain version at head dim 256, MQA 8:1
# ---------------------------------------------------------------------------
def _qkv(b, sq, sk, h, kh, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, kh, d).astype(np.float32),
            rs.randn(b, sk, kh, d).astype(np.float32))


# (B, Sq, Sk, (causal, q_offset, prefix_len)): paligemma's bidirectional
# prefix from position 0 (its prefill), a prefix longer than the q block,
# and a q block at an offset past the prefix (a chunked prefill's later
# chunk)
D256_CASES = {"prefix_prefill": (2, 64, 64, (True, 0, 16)),
              "prefix_past_the_q_block": (1, 24, 80, (True, 0, 40)),
              "offset_past_the_prefix": (2, 40, 72, (True, 32, 20))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(D256_CASES))
def test_plain_flash_d256_mqa8_prefix_matches_the_reference(case, dtype):
    """The wrapper's plain version (the CPU route of
    ``attention_cuda.flash_attention``), ``full_mha`` and ``chunked_mha``
    on the TORCH template, against the reference's ``full_mha`` and
    ``chunked_mha``: 8 query heads of 256 over one kv head, the prefix
    attended bidirectionally."""
    b, sq, sk, (causal, off, pre) = D256_CASES[case]
    q, k, v = _qkv(b, sq, sk, 8, 1, 256, seed=len(case))
    jq, jk, jv = (jnp.asarray(a, _JDT[dtype]) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    rspec = rattn.MaskSpec(causal=causal, q_offset=off, prefix_len=pre)
    spec = pattn.MaskSpec(causal=causal, q_offset=off, prefix_len=pre)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    want = rattn.full_mha(jq, jk, jv, rspec)
    _close(rattn.chunked_mha(jq, jk, jv, rspec, q_chunk=16, kv_chunk=32),
           want, tol, "reference chunked vs full")
    _close(attention_cuda.flash_attention(tq, tk, tv, spec), want, tol,
           "wrapper (plain)")
    _close(pattn.full_mha(tq, tk, tv, spec, template="TORCH"), want, tol,
           "full_mha")
    _close(pattn.chunked_mha(tq, tk, tv, spec, q_chunk=16, kv_chunk=32,
                             template="TORCH"), want, tol, "chunked_mha")
    # where a query row lies in the prefix, the prefix matters: causal-only
    # differs there; past the prefix every row sees all of it either way
    causal_only = np.asarray(rattn.full_mha(
        jq, jk, jv, rspec._replace(prefix_len=0)), np.float32)
    diff = float(np.abs(causal_only - np.asarray(want, np.float32)).max())
    assert (diff > 100 * tol) == (off < pre - 1), diff


@pytest.mark.parametrize("sq,sk,q_offset", [(128, 128, 0), (64, 128, 64)])
def test_plain_flash_d256_mqa8_matches_pallas_interpret(sq, sk, q_offset):
    """The reference's Pallas kernel (interpret mode; causal, no prefix, as
    it takes) against the wrapper's plain version at head dim 256, MQA
    8:1, in the kernel's (H, S, D) layout."""
    q, k, v = (a[0].transpose(1, 0, 2)
               for a in _qkv(1, sq, sk, 8, 1, 256, seed=sq + q_offset))
    want = np.asarray(r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_offset=q_offset, block_q=64,
                              block_k=64, interpret=True))
    got = attention_cuda.flash_attention(
        *(torch.from_numpy(a.transpose(1, 0, 2))[None] for a in (q, k, v)),
        pattn.MaskSpec(causal=True, q_offset=q_offset))
    _close(got[0].transpose(0, 1), want, F32_TOL, "pallas interpret")


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_split_k_twin_at_rb8_d256(kv_dtype):
    """The split-K decode's plain twin at paligemma's decode: one query row
    for each of 8 heads over one kv head (a block of RB 8 rows), head dim
    256, valid lengths about a split, against ``full_mha_reference`` and
    the reference's ``decode_mha`` (bf16 q; the cache read in q's
    dtype)."""
    assert attention_cuda.decode_rows(1, 8) == (8, 1)
    q, k, v = _qkv(3, 1, 600, 8, 1, 256, seed=21)
    valid = np.array([37, 256, 600])
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = (torch.from_numpy(a).to(kv_dtype) for a in (k, v))
    spec = pattn.MaskSpec(causal=False)
    split = attention_cuda.decode_split(8)
    got = ref.split_k_decode_reference(tq, tk, tv, spec, torch.tensor(valid),
                                       split=split)
    _close(got, ref.full_mha_reference(tq, tk, tv, spec,
                                       torch.tensor(valid)).float(),
           BF16_TOL, "full_mha_reference")
    want = rattn.decode_mha(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                              for t in (tq, tk, tv)),
                            jnp.asarray(valid, jnp.int32))
    _close(got, want, BF16_TOL, "reference decode_mha")


# ---------------------------------------------------------------------------
# the stubs and the pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_stubs_shape_dtype_scale_and_determinism(arch):
    """At the published widths: the shape and dtype the reference's stub
    gives, N(0, 1) / sqrt(d_model), the same draws from the same generator
    state and other draws from another."""
    cfg = registry.get_config(arch)
    rcfg = rreg.get_config(arch)
    if cfg.family == "audio":
        make = lambda g, **kw: multimodal.frame_embeddings(g, cfg, 2, 300,
                                                           **kw)
        shape = (2, 300, cfg.d_model)
    else:
        make = lambda g, **kw: multimodal.patch_embeddings(g, cfg, 2, **kw)
        shape = (2, rcfg.num_prefix_tokens, cfg.d_model)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    x = make(gen(0))
    assert tuple(x.shape) == shape and x.dtype == cfg.compute_dtype
    assert _JDT[x.dtype] == rcfg.compute_dtype
    xf = make(gen(0), dtype=torch.float32)
    assert xf.dtype == torch.float32
    assert torch.equal(xf.to(cfg.compute_dtype), x)
    assert abs(float(xf.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.01
    assert abs(float(xf.mean())) * np.sqrt(cfg.d_model) < 0.01
    assert torch.equal(make(gen(0)), x)
    assert not torch.equal(make(gen(1)), x)


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batches_bitwise_run_to_run(arch):
    """The pipeline's batches of both families: equal bit for bit from a
    second dataset, other stubs at another step or shard, the stub drawn
    from a generator seeded with the reference's key, targets (and
    paligemma's tokens) the reference's."""
    cfg = registry.smoke(registry.get_config(arch))
    rcfg = rreg.smoke(rreg.get_config(arch))
    kw = dict(seed=3, vocab_size=cfg.vocab_size, seq_len=40, global_batch=4,
              doc_len_mean=30)
    make = lambda: pipeline.PackedLMDataset(pipeline.DataConfig(**kw), cfg)
    a, b = make().batch(5, 1, 2), make().batch(5, 1, 2)
    want = rpipe.PackedLMDataset(rpipe.DataConfig(**kw), rcfg).batch(5, 1, 2)
    assert sorted(a) == sorted(want)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
        assert a[k].shape == want[k].shape, k
    for k in ("tokens", "targets"):
        if k in want:
            np.testing.assert_array_equal(a[k], want[k])
    if cfg.family == "audio":
        stub, key = "embeds", hash((3, 5, 1))
        draw = multimodal.frame_embeddings(
            torch.Generator().manual_seed(key % 2 ** 31), cfg, 2, 40)
    else:
        stub, key = "prefix_embeds", hash((3, 3, 5, 1))
        draw = multimodal.patch_embeddings(
            torch.Generator().manual_seed(key % 2 ** 31), cfg, 2)
    assert np.array_equal(a[stub], draw.float().numpy())
    for other in (make().batch(6, 1, 2), make().batch(5, 0, 2)):
        assert not np.array_equal(other[stub], a[stub])


def test_the_multimodal_families_share_the_dense_stack():
    """The reference routes ``audio`` and ``vlm`` through its dense stack
    (transformer.py's family tests); so does the port: an attention block
    with a SwiGLU MLP per layer, one stacked KV cache."""
    for arch in ARCHS:
        cfg = registry.smoke(registry.get_config(arch))
        assert cfg.family in transformer.FAMILIES
        lm = model.init_params(cfg, 0, device="cpu")
        assert lm.stack.stacked and not hasattr(lm.stack, "shared_attn")
        assert all(isinstance(lp, transformer.AttnBlock) and
                   isinstance(lp.ffn, layers.MLP) for lp in lm.stack.layers)
        caches = model.init_caches(cfg, 2, 16, torch.float32, "cpu")
        assert caches.k.shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads,
                                  cfg.head_dim)
        rcfg = rreg.smoke(rreg.get_config(arch))
        rc = rtransformer.init_caches(rcfg, 2, 16, jnp.float32)
        assert tuple(caches.k.shape) == rc.k.shape
