"""FLASH_ATTENTION's plain version and the attention modules of the port
against the JAX reference, on the CPU.

Seeded numpy inputs go through both packages: the reference's Pallas
``flash_attention`` in interpret mode and its ``mha_reference``,
``chunked_mha``, ``full_mha``, ``decode_mha`` and ``blocks.attention``,
against the port's ``kernels.attention.flash_attention``, ``ops.mha``,
``models.attention`` and ``models.blocks``.  The CUDA wrapper's CPU route
is the plain version; the kernel itself is checked on the card
(``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.attention import flash_attention as r_flash  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro_torch.kernels import attention as pflash  # noqa: E402
from repro_torch.kernels import attention_cuda, ops, ref  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import blocks as pblocks  # noqa: E402

# float32: the two packages sum the same terms in another order;
# 2e-6 of the output's scale (|out| <= max|v| ~ 4) covers it.
F32_TOL = 2e-6
# bfloat16 outputs: both round a float32 result to 8 significant bits; one
# rounding may fall on the other side, one bf16 ulp (2^-7 relative).
BF16_TOL = 2.0 ** -7


def _rand(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _both(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(dtype)


def _close(got: torch.Tensor, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


# -- the kernel's own API: (H, Sq, D) ------------------------------------------
@pytest.mark.parametrize("h,hkv,sq,sk,causal,q_offset", [
    (4, 4, 128, 128, True, 0),
    (4, 2, 64, 128, True, 64),
    (8, 2, 128, 256, False, 0),
    (4, 1, 64, 64, True, 0),
])
def test_plain_flash_matches_pallas_interpret_and_oracle(h, hkv, sq, sk,
                                                         causal, q_offset):
    q, k, v = (_rand(s, i) for i, s in
               enumerate([(h, sq, 32), (hkv, sk, 32), (hkv, sk, 32)]))
    jq, tq = _both(q, torch.float32)
    jk, tk = _both(k, torch.float32)
    jv, tv = _both(v, torch.float32)
    want = r_flash(jq, jk, jv, causal=causal, q_offset=q_offset, block_q=64,
                   block_k=64, interpret=True)
    got = pflash.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                                 block_q=64, block_k=64)
    _close(got, want, torch.float32, "vs pallas interpret")
    oracle = rref.mha_reference(jq.transpose(1, 0, 2), jk.transpose(1, 0, 2),
                                jv.transpose(1, 0, 2), causal=causal,
                                q_offset=q_offset)
    _close(got.transpose(0, 1), oracle, torch.float32, "vs mha_reference")
    port_oracle = ref.mha_reference(tq.transpose(0, 1), tk.transpose(0, 1),
                                    tv.transpose(0, 1), causal=causal,
                                    q_offset=q_offset)
    _close(port_oracle, oracle, torch.float32, "oracles")


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 7), (False, 0)])
def test_ops_mha_builds_a_maskspec(causal, q_offset):
    """The port's ``ops.mha`` runs ``chunked_mha`` with a ``MaskSpec`` (the
    reference's non-TPU branch passes ``causal=``/``q_offset=`` keywords
    that its ``chunked_mha`` does not take); it takes any Sq and Sk."""
    q, k, v = _rand((4, 50, 32), 0), _rand((2, 61, 32), 1), _rand((2, 61, 32), 2)
    got = ops.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  causal=causal, q_offset=q_offset, block_q=16, block_k=32)
    want = rref.mha_reference(jnp.asarray(q.transpose(1, 0, 2)),
                              jnp.asarray(k.transpose(1, 0, 2)),
                              jnp.asarray(v.transpose(1, 0, 2)),
                              causal=causal, q_offset=q_offset)
    _close(got.transpose(0, 1), want, torch.float32)
    with pytest.raises(ValueError, match="unknown template"):
        ops.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                template="PALLAS")


# -- the model's BSHD regions ----------------------------------------------------
SWEEP = [  # (B, Sq, Sk, H, KH, spec, valid)
    (2, 9, 9, 4, 4, (True, 0, 0), None),
    (2, 9, 17, 4, 2, (True, 8, 0), None),
    (1, 33, 33, 8, 2, (True, 0, 5), None),
    (2, 12, 40, 4, 1, (True, 28, 0), 35),
    (3, 1, 50, 4, 2, (False, 0, 0), (1, 20, 50)),
    (2, 5, 30, 4, 4, (False, 0, 0), 0),
]


def _sweep_inputs(case, dtype, seed=0):
    b, sq, sk, h, kh, (causal, off, pre), valid = case
    q = _rand((b, sq, h, 32), seed)
    k, v = _rand((b, sk, kh, 32), seed + 1), _rand((b, sk, kh, 32), seed + 2)
    rspec = rattn.MaskSpec(causal=causal, q_offset=off, prefix_len=pre)
    pspec = pattn.MaskSpec(causal=causal, q_offset=off, prefix_len=pre)
    jv = tv = valid
    if isinstance(valid, tuple):
        jv, tv = jnp.asarray(valid, jnp.int32), torch.tensor(valid)
    return [_both(a, dtype) for a in (q, k, v)], rspec, pspec, jv, tv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_full_mha_matches_reference(case, dtype):
    (jq, tq), (jk, tk), (jvv, tvv) = _sweep_inputs(SWEEP[case], dtype)[0]
    _, rspec, pspec, jv, tv = _sweep_inputs(SWEEP[case], dtype)
    want = rattn.full_mha(jq, jk, jvv, rspec, kv_valid_len=jv)
    got = pattn.full_mha(tq, tk, tvv, pspec, kv_valid_len=tv)
    assert got.dtype == dtype and got.shape == tq.shape
    _close(got, want, dtype)
    # the CUDA wrapper's CPU route is this plain version
    before = dict(attention_cuda.LAUNCHES)
    wrapped = attention_cuda.flash_attention(tq, tk, tvv, pspec, tv)
    assert torch.equal(wrapped, got) and attention_cuda.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in range(len(SWEEP))
                                  if not isinstance(SWEEP[c][6], tuple)])
def test_chunked_mha_matches_reference(case, dtype):
    ins, rspec, pspec, jv, tv = _sweep_inputs(SWEEP[case], dtype, seed=3)
    (jq, tq), (jk, tk), (jvv, tvv) = ins
    want = rattn.chunked_mha(jq, jk, jvv, rspec, q_chunk=4, kv_chunk=8,
                             kv_valid_len=jv)
    got = pattn.chunked_mha(tq, tk, tvv, pspec, q_chunk=4, kv_chunk=8,
                            kv_valid_len=tv)
    _close(got, want, dtype)
    # one kv chunk (the model's kv_chunk = 2^30) equals full_mha's masking
    full = pattn.full_mha(tq, tk, tvv, pspec, kv_valid_len=tv)
    one = pattn.chunked_mha(tq, tk, tvv, pspec, q_chunk=1024, kv_chunk=1 << 30,
                            kv_valid_len=tv)
    _close(one, full.float().numpy(), dtype)


def test_chunked_mha_takes_one_valid_length():
    q = torch.zeros(2, 3, 2, 32)
    with pytest.raises(ValueError, match="one valid length"):
        pattn.chunked_mha(q, q, q, kv_valid_len=torch.tensor([1, 2]))


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_mha_reads_a_float32_cache_in_q_dtype(per_slot):
    """The reference casts the cache to the compute dtype before
    ``decode_mha``; the port passes the float32 cache and reads it in q's
    dtype: the same values."""
    q = _rand((3, 1, 4, 32), 0)
    kc, vc = _rand((3, 40, 2, 32), 1), _rand((3, 40, 2, 32), 2)
    lens = (5, 40, 17) if per_slot else 23
    jl = jnp.asarray(lens, jnp.int32) if per_slot else lens
    tl = torch.tensor(lens) if per_slot else lens
    want = rattn.decode_mha(jnp.asarray(q, jnp.bfloat16),
                            jnp.asarray(kc).astype(jnp.bfloat16),
                            jnp.asarray(vc).astype(jnp.bfloat16), jl)
    got = pattn.decode_mha(torch.from_numpy(q).bfloat16(),
                           torch.from_numpy(kc), torch.from_numpy(vc), tl)
    _close(got, want, torch.bfloat16)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(1, 4, 4, 32)
    spec = pattn.MaskSpec()
    with pytest.raises(ValueError, match="B, S, H, D"):
        attention_cuda.flash_attention(q[0], q, q, spec)
    with pytest.raises(TypeError, match="float16"):
        attention_cuda.flash_attention(q.half(), q, q, spec)
    with pytest.raises(ValueError, match="do not match"):
        attention_cuda.flash_attention(q, q[..., :16], q[..., :16], spec)
    with pytest.raises(ValueError, match="kv heads"):
        attention_cuda.flash_attention(q, q[:, :, :3], q[:, :, :3], spec)
    with pytest.raises(ValueError, match="rows"):
        attention_cuda.flash_attention(q, q, q, spec, torch.tensor([1, 2]))
    with pytest.raises(TypeError, match="kv_valid_len"):
        attention_cuda.flash_attention(q, q, q, spec, 2.5)
    with pytest.raises(ValueError, match="contiguous"):
        attention_cuda.flash_attention(q.transpose(2, 3), q, q, spec)


# -- the attention block: prefill writes the cache, decode appends ------------
@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_block_prefill_and_decode_match_reference(per_slot):
    import jax

    from repro_torch import convert

    b, s, d, h, kh, hd, smax = 2, 12, 64, 4, 2, 16, 24
    rp = rblocks.init_attention(jax.random.PRNGKey(0), d, h, kh, hd,
                                jnp.float32, qkv_bias=True)
    rp = {k: v + 0.01 * i for i, (k, v) in enumerate(rp.items())}
    pp = pblocks.Attention(None, d, h, kh, hd, torch.float32, "meta",
                           qkv_bias=True)
    pp.load_state_dict({k: convert._tensor(np.asarray(v))
                        for k, v in rp.items()}, assign=True)
    x = _rand((b, s, d), 5)
    rcache = rblocks.KVCache(jnp.zeros((b, smax, kh, hd)),
                             jnp.zeros((b, smax, kh, hd)))
    pcache = pblocks.KVCache(torch.zeros(b, smax, kh, hd),
                             torch.zeros(b, smax, kh, hd))
    kw = dict(rope_theta=10_000.0, q_chunk=8, kv_chunk=8)
    ry, rcache = rblocks.attention(rp, jnp.asarray(x), positions=jnp.arange(s),
                                   mask=rattn.MaskSpec(), cache=rcache, **kw)
    py, same = pblocks.attention(pp, torch.from_numpy(x),
                                 positions=torch.arange(s),
                                 mask=pattn.MaskSpec(), cache=pcache, **kw)
    assert same is pcache                      # written in place
    _close(py, ry, torch.float32, "prefill")
    for r, p in zip(rcache, pcache):
        _close(p, r, torch.float32, "prefill cache")

    xt = _rand((b, 1, d), 6)
    lens = (12, 7)
    if per_slot:
        jl, tl = jnp.asarray(lens, jnp.int32), torch.tensor(lens)
        rpos, ppos = jl.reshape(-1, 1), tl.reshape(-1, 1)
    else:
        jl = tl = lens[0]
        rpos, ppos = jnp.asarray([jl]), torch.tensor([tl])
    ry, rcache = rblocks.attention(rp, jnp.asarray(xt), positions=rpos,
                                   mask=rattn.MaskSpec(), cache=rcache,
                                   cache_len=jl, **kw)
    py, pcache = pblocks.attention(pp, torch.from_numpy(xt), positions=ppos,
                                   mask=pattn.MaskSpec(), cache=pcache,
                                   cache_len=tl, **kw)
    _close(py, ry, torch.float32, "decode")
    for r, p in zip(rcache, pcache):
        _close(p, r, torch.float32, "decode cache")


# -- the split-K decode route's plain twin ------------------------------------
# (B, Sq, Sk, H, KH, (causal, q_offset, prefix_len), valid, q dtype, kv dtype)
SPLIT_K_CASES = {
    # 256-key splits that do not divide the valid lengths or Sk
    "valid_255_256_257": (3, 1, 600, 4, 4, (False, 0, 0), (255, 256, 257),
                          torch.float32, torch.float32),
    # a row with no valid key averages v over all Sk keys
    "blind_valid_0": (2, 1, 520, 4, 2, (False, 0, 0), (0, 520),
                      torch.float32, torch.float32),
    # rows 0-1 see no key (blind), rows 2-3 see one and two
    "q_offset_negative": (2, 4, 300, 4, 2, (True, -2, 0), None,
                          torch.float32, torch.float32),
    "gqa_rep4": (2, 1, 600, 8, 2, (False, 0, 0), (300, 599),
                 torch.float32, torch.float32),
    "f32_cache_bf16_q": (3, 1, 600, 8, 2, (False, 0, 0), (37, 256, 600),
                         torch.bfloat16, torch.float32),
    "prefix_offset_bf16": (2, 3, 520, 8, 2, (True, 258, 5), (500, 3),
                           torch.bfloat16, torch.float32),
}


def _split_k_inputs(case, seed=11):
    b, sq, sk, h, kh, (causal, off, pre), valid, qdt, kvdt = \
        SPLIT_K_CASES[case]
    q = _rand((b, sq, h, 32), seed)
    k, v = _rand((b, sk, kh, 32), seed + 1), _rand((b, sk, kh, 32), seed + 2)
    tq = torch.from_numpy(q).to(qdt)
    tk, tv = (torch.from_numpy(a).to(kvdt) for a in (k, v))
    pspec = pattn.MaskSpec(causal=causal, q_offset=off, prefix_len=pre)
    tvalid = None if valid is None else torch.tensor(valid)
    return (q, k, v), (tq, tk, tv), pspec, tvalid


def _to_jax(a, dtype):
    """The values as jax arrays in ``dtype`` (the reference casts a float32
    cache to the compute dtype before attending)."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(a, jd)


@pytest.mark.parametrize("case", list(SPLIT_K_CASES))
def test_split_k_twin_matches_full_mha_reference(case):
    _, (tq, tk, tv), spec, valid = _split_k_inputs(case)
    got = ref.split_k_decode_reference(tq, tk, tv, spec, valid)
    want = ref.full_mha_reference(tq, tk, tv, spec, valid)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want.float().numpy(), tq.dtype)


@pytest.mark.parametrize("case", list(SPLIT_K_CASES))
def test_split_k_twin_matches_reference_full_mha(case):
    (q, k, v), (tq, tk, tv), spec, valid = _split_k_inputs(case)
    rspec = rattn.MaskSpec(causal=spec.causal, q_offset=spec.q_offset,
                           prefix_len=spec.prefix_len)
    jvalid = None if valid is None else jnp.asarray(valid.numpy(), jnp.int32)
    want = rattn.full_mha(_to_jax(q, tq.dtype), _to_jax(k, tq.dtype),
                          _to_jax(v, tq.dtype), rspec, kv_valid_len=jvalid)
    got = ref.split_k_decode_reference(tq, tk, tv, spec, valid)
    _close(got, want, tq.dtype)


@pytest.mark.parametrize("case", [c for c, a in SPLIT_K_CASES.items()
                                  if a[1] == 1 and not a[5][0]])
def test_split_k_twin_matches_reference_decode_mha(case):
    (q, k, v), (tq, tk, tv), spec, valid = _split_k_inputs(case)
    want = rattn.decode_mha(_to_jax(q, tq.dtype), _to_jax(k, tq.dtype),
                            _to_jax(v, tq.dtype),
                            jnp.asarray(valid.numpy(), jnp.int32))
    got = ref.split_k_decode_reference(tq, tk, tv, spec, valid)
    _close(got, want, tq.dtype)


@pytest.mark.parametrize("split", [1, 64, 100, 128, 256, 600, 1000])
def test_split_k_twin_any_split_size(split):
    """One split per key up to one split for all of them: the merge gives
    the same rows (blind, GQA, ragged valid lengths in one batch)."""
    _, (tq, tk, tv), spec, _ = _split_k_inputs("gqa_rep4")
    valid = torch.tensor([0, 257])
    got = ref.split_k_decode_reference(tq, tk, tv, spec, valid, split=split)
    want = ref.full_mha_reference(tq, tk, tv, spec, valid)
    _close(got, want.numpy(), torch.float32)


def test_route_table():
    bf, f32 = torch.bfloat16, torch.float32
    route = attention_cuda.route
    assert route(bf, bf, 9) == route(bf, bf, 1024) == "tensor_core_prefill"
    assert route(bf, f32, 1) == route(bf, bf, 8) == "split_k_decode"
    assert route(bf, f32, 9) == "cuda_core"
    assert {route(f32, kv, sq) for kv in (bf, f32) for sq in (1, 8, 9, 512)} \
        == {"cuda_core"}
    assert set(attention_cuda.ROUTE_LAUNCHES) == set(attention_cuda.ROUTES)


@pytest.mark.parametrize("sq,rep,want", [
    (1, 1, (1, 1)), (1, 4, (4, 1)), (3, 1, (4, 1)), (1, 8, (8, 1)),
    (2, 4, (8, 1)), (8, 8, (8, 8)), (3, 3, (8, 2)), (5, 2, (8, 2)),
])
def test_decode_rows_cover_every_query_row(sq, rep, want):
    per_block, groups = attention_cuda.decode_rows(sq, rep)
    assert (per_block, groups) == want
    assert per_block * groups >= sq * rep > per_block * (groups - 1)
    # blocks of 4 or more rows (GQA) take 128-key splits, the others 256
    assert attention_cuda.decode_split(per_block) == (
        128 if per_block >= 4 else 256)


def test_new_routes_need_16_byte_rows():
    q = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    attention_cuda.check_rows_aligned(q, "q", "tensor_core_prefill")
    attention_cuda.check_rows_aligned(q[:, :1], "q", "split_k_decode")
    with pytest.raises(ValueError, match="16-byte"):
        shifted = torch.zeros(4 + q.numel(), dtype=torch.bfloat16)[4:]
        attention_cuda.check_rows_aligned(shifted.view(q.shape), "k", "x")
    wide = torch.zeros(1, 4, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        attention_cuda.check_rows_aligned(wide, "v", "x")
