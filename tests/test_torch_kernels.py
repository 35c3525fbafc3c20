"""The port's stencil kernels against the JAX reference, on the CPU.

For each of the four kernels, the port's plain version (the function the
CUDA kernel is checked against on the card), its TORCH generator template
and its CUDA template (which on CPU tensors runs the plain version) are
held against the reference's Pallas 3DBLOCK kernel in interpret mode, its
JNP template and its independent oracles in ``repro.kernels.ref``, on the
same seeded inputs: unbatched, slot-batched (S=3, distinct parameters per
slot) and at an odd interior shape.

Against the reference's JNP template the port is bitwise equal: the same
float32 expression in the same order, with the terms derived from ``h`` and
``omega`` (1/h, 1/h², h², 1 - omega) computed in double and rounded once,
as the reference's literals are — in the table-fed plain version too.
Against the Pallas interpreter and the oracles, rtol 2e-7 / atol 1e-7
(about one ulp): those evaluate some sums in another order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_harness import padded_inputs, seeded  # installs the shim

import jax.numpy as jnp
from repro.core import generator as ref_generator
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.kernels import stencil3d as ref_stencil3d
from repro.kernels.jacobi import jacobi_fused_ref as ref_jacobi_fused

from repro_torch.core import generator
from repro_torch.core.descriptor import descriptor
from repro_torch.kernels import ops, ref, stencil3d, stencil3d_cuda
from repro_torch.kernels.jacobi import jacobi_fused_ref

RTOL, ATOL = 2e-7, 1e-7
KERNELS = tuple(stencil3d.DESCRIPTORS)

# per-slot parameter values (row s = slot s); unbatched calls use row 0
PARAMS = dict(dt=[0.01, 0.02, 0.005], h=[0.1, 0.1, 0.1],
              nu=[0.05, 0.01, 0.1], fx=[0.1, 0.0, -0.1], fy=[0.0, 0.2, 0.0],
              fz=[-0.2, 0.0, 0.1], omega=[0.8, 1.0, 1.2])
# forms: (slots, interior)
FORMS = {"unbatched": (None, (8, 8, 8)), "batched": (3, (8, 8, 8)),
         "odd": (None, (5, 7, 3))}
# the reference's oracle signatures
ORACLES = {
    "UPDATE_VELOCITY": lambda a, p: ref_oracle.update_velocity(
        a["vx"], a["vy"], a["vz"], **p),
    "DIVERGENCE": lambda a, p: (ref_oracle.divergence(
        a["vx"], a["vy"], a["vz"], h=p["h"]),),
    "JACOBI_PRESSURE": lambda a, p: (ref_oracle.jacobi_pressure(
        a["p"], a["rhs"], **p),),
    "PROJECT_VELOCITY": lambda a, p: ref_oracle.project_velocity(
        a["vx"], a["vy"], a["vz"], a["p"], **p),
}


def _case(name, form):
    slots, interior = FORMS[form]
    desc = stencil3d.DESCRIPTORS[name]
    arrays = padded_inputs(desc, interior, seed=11, slots=slots)
    rows = slice(None) if slots else 0
    # h is a Python scalar (a grid constant, as the solver passes it);
    # the rest are float32 values, per slot when batched
    params = {p: (PARAMS[p][0] if p == "h" else
                  np.asarray(PARAMS[p][:slots] if slots else PARAMS[p][0],
                             np.float32))
              for p in desc.parameters}
    # the table the CUDA template builds from these parameters
    table = generator.param_table(
        desc, {k: v if isinstance(v, float) else torch.from_numpy(v)
               for k, v in params.items()},
        slots, "cpu", columns=stencil3d.TABLES[name])[rows]
    return desc, slots, interior, arrays, params, table


def _reference(name, form, which):
    desc, slots, interior, arrays, params, _ = _case(name, form)
    rdesc = ref_stencil3d.DESCRIPTORS[name]
    body = ref_stencil3d.BODIES[name]
    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}
    jpar = {k: (v if isinstance(v, float) else jnp.asarray(v))
            for k, v in params.items()}
    if which == "oracle":
        def one(s):
            a = {k: v if s is None else v[s] for k, v in jarr.items()}
            p = {k: (v if isinstance(v, float) or s is None else v[s])
                 for k, v in jpar.items()}
            return [np.asarray(o) for o in ORACLES[name](a, p)]
        if slots is None:
            return one(None)
        per = [one(s) for s in range(slots)]
        return [np.stack([per[s][i] for s in range(slots)])
                for i in range(len(per[0]))]
    if which == "pallas":
        kern = ref_generator.generate(
            dataclasses.replace(rdesc, tile=interior), body,
            template="3DBLOCK", interpret=True)
    else:
        kern = ref_generator.generate(rdesc, body, template="JNP")
    if slots is None:
        out = kern(jarr, **jpar)
    else:
        batched = tuple(k for k, v in jpar.items() if not isinstance(v, float))
        out = kern.apply_batched(jarr, batched_params=batched, **jpar)
    return [np.asarray(out[k]) for k in rdesc.outputs]


def _port(name, form, which):
    desc, slots, _, arrays, params, table = _case(name, form)
    tarr = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tpar = {k: (v if isinstance(v, float) else torch.from_numpy(v))
            for k, v in params.items()}
    if which == "plain":
        out = stencil3d_cuda.PLAIN[name](*(tarr[k] for k in desc.inputs), table)
        out = out if isinstance(out, tuple) else (out,)
        return [o.numpy() for o in out]
    kern = generator.generate(desc, stencil3d.BODIES[name], template=which)
    if slots is None:
        res = kern(tarr, **tpar)
    else:
        batched = tuple(k for k, v in tpar.items() if not isinstance(v, float))
        res = kern.apply_batched(tarr, batched_params=batched, **tpar)
    return [res[k].numpy() for k in desc.outputs]


@pytest.mark.parametrize("reference", ["pallas", "jnp", "oracle"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", KERNELS)
def test_port_matches_reference(name, form, reference):
    want = _reference(name, form, reference)
    for which in ("plain", "TORCH", "CUDA"):
        got = _port(name, form, which)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, (which, g.shape, w.shape)
            if reference == "jnp":
                np.testing.assert_array_equal(g, w, err_msg=f"{which} vs jnp")
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{which} vs {reference}")


@pytest.mark.parametrize("name", KERNELS)
def test_torch_oracles_match_reference_oracles(name):
    """``repro_torch.kernels.ref`` (independent of the generator) against
    ``repro.kernels.ref`` on the same inputs."""
    desc, _, _, arrays, params, _ = _case(name, "unbatched")
    p = {k: float(v) for k, v in params.items()}
    want = ORACLES[name]({k: jnp.asarray(v) for k, v in arrays.items()}, p)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    fn = {"UPDATE_VELOCITY": lambda: ref.update_velocity(t["vx"], t["vy"], t["vz"], **p),
          "DIVERGENCE": lambda: (ref.divergence(t["vx"], t["vy"], t["vz"], h=p["h"]),),
          "JACOBI_PRESSURE": lambda: (ref.jacobi_pressure(t["p"], t["rhs"], **p),),
          "PROJECT_VELOCITY": lambda: ref.project_velocity(
              t["vx"], t["vy"], t["vz"], t["p"], **p)}[name]
    for g, w in zip(fn(), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", KERNELS)
def test_descriptors_field_equal_to_reference(name):
    a, b = stencil3d.DESCRIPTORS[name], ref_stencil3d.DESCRIPTORS[name]
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "variables":
            assert [dataclasses.asdict(g) | {"intent": g.intent.value} for g in va] == \
                   [dataclasses.asdict(g) | {"intent": g.intent.value} for g in vb]
        else:
            assert va == vb, f.name
    assert a.halo_lo == b.halo_lo and a.halo_hi == b.halo_hi
    assert a.inputs == b.inputs and a.outputs == b.outputs
    assert a.cached_inputs == b.cached_inputs
    assert [a.param_index(p) for p in a.parameters] == \
           [b.param_index(p) for p in b.parameters]
    assert a.vmem_block_bytes() == b.vmem_block_bytes()


def test_fused_jacobi_ref_matches_reference():
    p, rhs = seeded((12, 12, 12), 3), seeded((12, 12, 12), 4)
    want = ref_jacobi_fused(jnp.asarray(p), jnp.asarray(rhs), h=0.1,
                            omega=0.9, sweeps=2)
    got = jacobi_fused_ref(torch.from_numpy(p), torch.from_numpy(rhs), h=0.1,
                           omega=0.9, sweeps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_ops_default_to_torch_template_on_cpu_and_match_reference_ops():
    desc = stencil3d.JACOBI_PRESSURE
    a = padded_inputs(desc, (6, 6, 6), seed=5)
    got = ops.jacobi_pressure(torch.from_numpy(a["p"]), torch.from_numpy(a["rhs"]),
                              h=0.2, omega=1.0, tile=(2, 2, 2))
    want = ref_ops.jacobi_pressure(jnp.asarray(a["p"]), jnp.asarray(a["rhs"]),
                                   h=0.2, omega=1.0, template="JNP")
    assert ops.default_template("cpu") == "TORCH"
    assert ops.default_template("cuda:0") == "CUDA"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# -- the CUDA template and the wrappers, on the CPU ---------------------------
def test_cuda_template_rejects_a_descriptor_without_a_kernel():
    """A descriptor with no hand-written kernel gets one generated from its
    body; a body the generator cannot translate (here ``torch.exp``, whose
    rounding the card and the CPU do not share) leaves it without a kernel,
    and the CUDA template raises by name on any device rather than run the
    body in the kernel's place."""
    desc = descriptor("SMOOTH", stencil=(1, 1, 0, 0, 0, 0), tile=(4, 4, 4),
                      u=dict(names=("u",), intent="SEPARATEINOUT"))
    kern = generator.generate(desc, lambda ctx: {"u": torch.exp(ctx["u"].c)},
                              template="CUDA")
    with pytest.raises(ValueError, match="SMOOTH.*torch.exp"):
        kern({"u": torch.zeros(6, 4, 4)})
    torch_kern = generator.generate(desc, lambda ctx: {"u": ctx["u"].at(1, 0, 0)},
                                    template="TORCH")
    assert torch_kern({"u": torch.zeros(6, 4, 4)})["u"].shape == (4, 4, 4)


def test_cuda_template_rejects_a_foreign_body():
    kern = generator.generate(stencil3d.DIVERGENCE, lambda ctx: {"div": ctx["vx"].c})
    assert kern.template == "CUDA"   # 3DBLOCK descriptors default to CUDA
    v = torch.zeros(5, 5, 5)
    with pytest.raises(ValueError, match="DIVERGENCE"):
        kern({"vx": v, "vy": v, "vz": v}, h=0.1)


def test_param_table_follows_descriptor_order():
    desc = stencil3d.UPDATE_VELOCITY
    params = dict(fz=3.0, dt=torch.tensor(0.5), h=2.0, nu=torch.tensor(0.25),
                  fx=1.0, fy=torch.tensor(1.5))
    tab = generator.param_table(desc, params, None, "cpu")
    assert tab.shape == (1, 6) and tab.dtype == torch.float32
    assert tab[0].tolist() == [0.5, 2.0, 0.25, 1.0, 1.5, 3.0]
    per_slot = dict(params, nu=torch.tensor([0.1, 0.2, 0.3]))
    tab = generator.param_table(desc, per_slot, 3, "cpu")
    assert tab.shape == (3, 6)
    np.testing.assert_allclose(tab[:, desc.param_index("nu")].numpy(),
                               [0.1, 0.2, 0.3], rtol=1e-7)
    np.testing.assert_array_equal(tab[:, desc.param_index("dt")].numpy(), 0.5)


def test_wrappers_validate_inputs_and_count_no_cpu_launches():
    desc = stencil3d.JACOBI_PRESSURE
    a = {k: torch.from_numpy(v) for k, v in padded_inputs(desc, (4, 5, 6), 2).items()}
    table = torch.tensor([0.01, 1.0, 0.0])     # h^2, omega, 1 - omega
    before = dict(stencil3d_cuda.LAUNCHES)
    out = stencil3d_cuda.jacobi_pressure(a["p"], a["rhs"], table)
    assert out.shape == (4, 5, 6)
    assert stencil3d_cuda.LAUNCHES == before      # CPU runs the plain version
    with pytest.raises(TypeError, match="float32"):
        stencil3d_cuda.jacobi_pressure(a["p"].double(), a["rhs"], table)
    with pytest.raises(ValueError, match="contiguous"):
        stencil3d_cuda.jacobi_pressure(a["p"].transpose(0, 1), a["rhs"], table)
    with pytest.raises(ValueError, match="interior"):
        stencil3d_cuda.jacobi_pressure(a["p"], a["rhs"][:-1], table)
    with pytest.raises(ValueError, match="parameter table"):
        stencil3d_cuda.jacobi_pressure(a["p"], a["rhs"], torch.tensor([0.1]))


def test_field_view_rejects_offsets_beyond_the_declared_radii():
    view = generator.FieldView(torch.zeros(3, 6, 6, 6), (1, 1, 1), (0, 0, 0))
    assert view.at(-1, 0, -1).shape == (3, 5, 5, 5)
    with pytest.raises(ValueError, match="exceeds declared radii"):
        view.at(1, 0, 0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("name", KERNELS)
def test_h_terms_are_rounded_once_from_double_at_the_ghia_grid(name):
    """At h = 1/48 (the Ghia grid) float32 arithmetic on float32(h) gives
    another h² than the double the reference bakes as a literal.  The
    table carries 1/h, 1/h², h² and 1 - omega computed in double and
    rounded once, so the table-fed plain version (what the CUDA kernel is
    held to) equals the TORCH template and the reference's JNP template
    bitwise."""
    h = 1.0 / 48
    assert np.float32(h) * np.float32(h) != np.float32(h * h)
    desc = stencil3d.DESCRIPTORS[name]
    params = {p: h if p == "h" else PARAMS[p][0] for p in desc.parameters}
    table = generator.param_table(desc, params, None, "cpu",
                                  columns=stencil3d.TABLES[name])[0]
    rounded_once = dict(h=h, ih=1.0 / h, ih2=(1.0 / h) * (1.0 / h), h2=h * h,
                        omc=1.0 - params.get("omega", 0.0))
    for i, col in enumerate(stencil3d.TABLES[name]):
        if col in rounded_once:
            assert table[i].item() == float(np.float32(rounded_once[col])), col
    arrays = padded_inputs(desc, (6, 5, 4), seed=3)
    tarr = {k: torch.from_numpy(v) for k, v in arrays.items()}
    plain = stencil3d_cuda.PLAIN[name](*(tarr[k] for k in desc.inputs), table)
    plain = plain if isinstance(plain, tuple) else (plain,)
    eager = generator.generate(desc, stencil3d.BODIES[name],
                               template="TORCH")(tarr, **params)
    ref = ref_generator.generate(
        ref_stencil3d.DESCRIPTORS[name], ref_stencil3d.BODIES[name],
        template="JNP")({k: jnp.asarray(v) for k, v in arrays.items()}, **params)
    for out, got in zip(desc.outputs, plain):
        np.testing.assert_array_equal(got.numpy(), eager[out].numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref[out]))


# -- the generated 3DBLOCK template (a descriptor with no hand-written kernel)
GRADIENT_CCL = """
CCTK_CUDA_KERNEL GRADIENT_MAG
  TYPE=3DBLOCK
  STENCIL="1,1,1,1,1,1"
  TILE="8,8,8"
{
  CCTK_CUDA_KERNEL_VARIABLE CACHED=YES INTENT=IN
  {
    phi
  } "SCALAR_FIELD"
  CCTK_CUDA_KERNEL_VARIABLE INTENT=OUT
  {
    gmag
  } "GRADIENT_MAGNITUDE"
  CCTK_CUDA_KERNEL_PARAMETER
  {
    h
  } "SPACING"
}
"""


def _gradient_body(sqrt):
    def body(ctx):
        phi, h = ctx["phi"], ctx.param("h")
        gx = (phi.at(1, 0, 0) - phi.at(-1, 0, 0)) / (2 * h)
        gy = (phi.at(0, 1, 0) - phi.at(0, -1, 0)) / (2 * h)
        gz = (phi.at(0, 0, 1) - phi.at(0, 0, -1)) / (2 * h)
        return {"gmag": sqrt(gx * gx + gy * gy + gz * gz)}
    return body


def _mixed_body(sqrt):
    """Asymmetric radii, an uncached input, two outputs, Python numbers on
    both sides, ``c / x``, ``** 2``, ``abs`` and negation."""
    def body(ctx):
        u, f = ctx["u"], ctx["f"]
        dt, w = ctx.param("dt"), ctx.param("w")
        lap = (u.at(1, 0, 0) + u.at(-1, 0, 0) + u.at(0, 0, 2) - 3.0 * u.c) / 6.0
        return {"v": u.c + dt * (lap - f.c) - 1.0 / w,
                "e": sqrt(abs(-u.at(0, 1, 0)) ** 2 + 0.5) * (2.0 - w)}
    return body


def _generated_cases(pkg):
    """(descriptor, body maker) pairs, built with ``pkg``'s own
    ``parse_ccl``/``descriptor``."""
    mixed = pkg.descriptor(
        "MIXED", stencil=(1, 1, 0, 1, 0, 2), tile=(4, 4, 4),
        parameters=("dt", "w"),
        field=dict(names=("u",), intent="IN"),
        rhs=dict(names=("f",), intent="IN", cached=False),
        out=dict(names=("v", "e"), intent="OUT"))
    return {"gradient_mag": (pkg.parse_ccl(GRADIENT_CCL)[0], _gradient_body),
            "mixed": (mixed, _mixed_body)}


def _generated_inputs(desc, slots):
    arrays = {k: torch.from_numpy(v) for k, v in
              padded_inputs(desc, (5, 6, 7), seed=21, slots=slots).items()}
    params = {"h": torch.tensor([0.1, 0.05, 0.2][:slots]),
              "dt": torch.tensor([0.01, 0.02, 0.03][:slots]),
              "w": torch.tensor([0.7, 1.3, 1.9][:slots])}
    return arrays, {p: params[p] for p in desc.parameters}


def _interpret(gen, inputs, table):
    """Run the traced nodes in eager float32: what gen_body computes."""
    vals = []
    for op, *args in gen.nodes:
        if op == "load":
            m, off = args
            name = gen.desc.inputs[m]
            cached = name in gen.desc.cached_inputs
            vals.append(generator.FieldView(
                inputs[m], gen.desc.halo_lo if cached else (0, 0, 0),
                gen.desc.halo_hi if cached else (0, 0, 0)).at(*off))
        elif op == "param":
            vals.append(table[:, args[0]].reshape(-1, 1, 1, 1))
        elif op == "const":
            vals.append(torch.tensor(args[0], dtype=torch.float32))
        else:
            a = [vals[i] for i in args]
            vals.append({"add": lambda: a[0] + a[1], "sub": lambda: a[0] - a[1],
                         "mul": lambda: a[0] * a[1], "div": lambda: a[0] / a[1],
                         "rcp": lambda: torch.reciprocal(a[0]),
                         "neg": lambda: -a[0], "abs": lambda: torch.abs(a[0]),
                         "sqrt": lambda: torch.sqrt(a[0])}[op]())
    return [vals[t] for t in gen.outputs]


@pytest.mark.parametrize("case", ["gradient_mag", "mixed"])
def test_generated_kernel_trace_is_the_body(case):
    """The traced nodes (what the generated kernel computes, op for op)
    evaluated eagerly equal the body's plain version bitwise, slot-batched
    with distinct parameters per slot."""
    from repro_torch import core

    desc, make = _generated_cases(core)[case]
    gen = stencil3d_cuda.generated(desc, make(torch.sqrt))
    arrays, params = _generated_inputs(desc, 3)
    table = generator.param_table(desc, params, 3, "cpu", columns=gen.columns)
    inputs = [arrays[k] for k in desc.inputs]
    want = gen.plain(*inputs, table)
    want = want if isinstance(want, tuple) else (want,)
    for got, w in zip(_interpret(gen, inputs, table), want):
        assert torch.equal(got.expand_as(w), w)
    assert gen.ops_per_cell == sum(op not in ("load", "param", "const")
                                   for op, *_ in gen.nodes)


@pytest.mark.parametrize("reference", ["pallas", "jnp"])
@pytest.mark.parametrize("case", ["gradient_mag", "mixed"])
def test_generated_kernel_matches_the_reference_3dblock_template(case,
                                                                 reference):
    """The port's CUDA template on a descriptor with no hand-written kernel
    (on CPU tensors: the generated kernel's plain version) against the
    reference's 3DBLOCK Pallas template in interpret mode and its JNP
    template, slot-batched, parameters through the scalar table."""
    from repro import core as ref_core
    from repro_torch import core

    desc, make = _generated_cases(core)[case]
    rdesc, _ = _generated_cases(ref_core)[case]
    arrays, params = _generated_inputs(desc, 3)
    kern = generator.generate(desc, make(torch.sqrt))
    assert kern.template == "CUDA"
    got = kern.apply_batched(arrays, batched_params=tuple(params), **params)
    if reference == "pallas":
        rkern = ref_generator.generate(
            dataclasses.replace(rdesc, tile=(5, 6, 7)), make(jnp.sqrt),
            template="3DBLOCK", interpret=True)
    else:
        rkern = ref_generator.generate(rdesc, make(jnp.sqrt), template="JNP")
    want = rkern.apply_batched({k: jnp.asarray(v.numpy())
                                for k, v in arrays.items()},
                               batched_params=tuple(params),
                               **{k: jnp.asarray(v.numpy())
                                  for k, v in params.items()})
    for name in desc.outputs:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL)


def test_generated_kernel_header_and_cpu_launches():
    """``gen_body`` declares the descriptor's counts, computes one line a
    node (a repeated read or product once) and writes every output; a CPU
    call launches nothing."""
    from repro_torch import core

    desc, make = _generated_cases(core)["mixed"]
    gen = stencil3d_cuda.generated(desc, make(torch.sqrt))
    head = gen.header
    assert "constexpr int kGenInputs = 2;" in head
    assert "constexpr int kGenOutputs = 2;" in head
    assert "constexpr int kGenParams = 2;" in head
    assert head.count("const float t") == len(gen.nodes)
    assert "a.out[0][o] = " in head and "a.out[1][o] = " in head
    assert "__fsqrt_rn(" in head and "__fdiv_rn(1.0f, " in head
    # f is uncached: read at the cell only, interior-shaped
    assert "const float* __restrict__ f1 = a.in[1] + s * ss1 + (i + 0)" in head
    loads = [args for op, *args in gen.nodes if op == "load"]
    assert len(loads) == len(set(map(tuple, loads))) == 6
    arrays, params = _generated_inputs(desc, 1)
    before = dict(stencil3d_cuda.GENERATED_LAUNCHES)
    generator.generate(desc, make(torch.sqrt))(
        {k: v[0] for k, v in arrays.items()},
        **{k: v[0] for k, v in params.items()})
    assert stencil3d_cuda.GENERATED_LAUNCHES == before
