"""Multi-tracer batched kernel: one Pallas call applies the SAME operator
to B tracers, reading the coefficients once per tile (no reference
counterpart — the reference applies its sparse matrix one vector at a
time; see ops/stencil_pallas.py). The kernel runs in the Pallas
interpreter here and is checked against the plain `apply_stencil`."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import otmb_tpu.ops.stencil_pallas as sp
from otmb_tpu.grid.geometry import makegridmetrics
from otmb_tpu.grid.indices import makeindices
from otmb_tpu.models.transport import transportmatrix
from otmb_tpu.ops.apply import apply_stencil
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
from otmb_tpu.ops.stencil_pallas import (
    apply_stencil_pallas_multi,
    euler_step_pallas_multi,
)
from otmb_tpu.utils.synthetic import synthetic_dataset


def _build(topology, nx, ny, nz, seed, nb):
    ds = synthetic_dataset(nx=nx, ny=ny, nz=nz, topology=topology, seed=seed)
    gm = makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
    )
    idx = makeindices(gm.v3d)
    phi = facefluxesfrommasstransport(
        umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx
    )
    ops = transportmatrix(
        phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx
    )
    wet = np.asarray(idx.wet3d)
    rng = np.random.default_rng(seed + 6)
    chis = np.where(
        wet[None], rng.standard_normal((nb,) + gm.shape), 0.0
    ).astype(np.float32)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    return gm, c32, chis


@pytest.fixture(scope="module", params=["bipolar", "tripolar"])
def case(request):
    gm, c32, chis = _build(request.param, 16, 8, 6, 5, 4)
    return gm.topology, c32, chis


@pytest.fixture(scope="module", params=["bipolar", "tripolar"])
def tall_case(request):
    """An 18 x 16 plane (288 cells), so a 64-cell tile gives five
    programs per level, the last one ragged."""
    gm, c32, chis = _build(request.param, 18, 16, 5, 11, 3)
    return gm.topology, c32, chis


@pytest.fixture
def small_tile(monkeypatch):
    monkeypatch.setattr(sp, "_TILE", 64)


def _ref_apply(coeffs, chis, topo):
    return np.stack([np.asarray(apply_stencil(coeffs, c, topo)) for c in chis])


def test_multi_apply_matches_single(case):
    topo, coeffs, chis = case
    out = np.asarray(apply_stencil_pallas_multi(coeffs, chis, topo,
                                                "interpret"))
    np.testing.assert_allclose(out, _ref_apply(coeffs, chis, topo),
                               rtol=1e-6, atol=1e-7)


def test_multi_euler_step_matches_single(case):
    topo, coeffs, chis = case
    dt = 300.0
    out = np.asarray(euler_step_pallas_multi(coeffs, chis, dt, topo,
                                             "interpret"))
    ref = chis - np.float32(dt) * _ref_apply(coeffs, chis, topo)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_multi_bf16_coeffs(case):
    """bf16 coefficient fields are widened to the f32 tracer dtype inside
    the kernel, as jnp promotion does in `apply_stencil`."""
    topo, coeffs, chis = case
    c16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), coeffs)
    out = np.asarray(apply_stencil_pallas_multi(c16, chis, topo, "interpret"))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, _ref_apply(c16, chis, topo),
                               rtol=1e-6, atol=1e-7)


def test_multi_route_jnp_matches_kernel(case):
    """The plain route (the CPU's) and the kernel agree."""
    topo, coeffs, chis = case
    kern = np.asarray(euler_step_pallas_multi(coeffs, chis, 50.0, topo,
                                              "interpret"))
    plain = np.asarray(euler_step_pallas_multi(coeffs, chis, 50.0, topo,
                                               "jnp"))
    np.testing.assert_allclose(kern, plain, rtol=1e-6, atol=1e-6)


def test_multi_rejects_bad_rank(case):
    topo, coeffs, chis = case
    with pytest.raises(ValueError, match="chis must be"):
        apply_stencil_pallas_multi(coeffs, chis[0], topo, "interpret")


def test_multi_propagation_conserves_mass(case):
    """A batched propagation loop conserves each tracer's volume-weighted
    total independently (CFL-stable step)."""
    topo, coeffs, chis = case
    ds = synthetic_dataset(nx=16, ny=8, nz=6, topology=topo.kind, seed=5)
    gm = makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
    )
    v = np.nan_to_num(np.asarray(gm.v3d)).astype(np.float64)
    dt = 0.25 / float(np.max(np.abs(np.asarray(coeffs.diag))))

    def body(i, c):
        return euler_step_pallas_multi(coeffs, c, dt, topo, "interpret")

    out = np.asarray(
        jax.jit(lambda c: jax.lax.fori_loop(0, 50, body, c))(chis)
    )
    for b in range(chis.shape[0]):
        m0 = float((chis[b].astype(np.float64) * v).sum())
        m1 = float((out[b].astype(np.float64) * v).sum())
        scale = float((np.abs(chis[b]).astype(np.float64) * v).sum())
        assert abs(m1 - m0) / scale < 1e-6  # f32 kernel arithmetic


def test_multi_tiles_apply_matches_reference(tall_case, small_tile):
    topo, coeffs, chis = tall_case
    out = np.asarray(apply_stencil_pallas_multi(coeffs, chis, topo,
                                                "interpret"))
    np.testing.assert_allclose(out, _ref_apply(coeffs, chis, topo),
                               rtol=1e-6, atol=1e-7)


def test_multi_tiles_euler_matches_reference(tall_case, small_tile):
    topo, coeffs, chis = tall_case
    out = np.asarray(euler_step_pallas_multi(coeffs, chis, 120.0, topo,
                                             "interpret"))
    ref = chis - np.float32(120.0) * _ref_apply(coeffs, chis, topo)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_propagate_multi_tiles_matches_stepwise(tall_case, small_tile):
    """A compiled loop of kernel steps equals the plain steps taken one
    at a time."""
    topo, coeffs, chis = tall_case
    dt, nsteps = 100.0, 6
    ref = jnp.asarray(chis)
    for _ in range(nsteps):
        ref = ref - dt * apply_stencil(coeffs, ref, topo)
    out = jax.jit(lambda c: jax.lax.fori_loop(
        0, nsteps,
        lambda i, v: euler_step_pallas_multi(coeffs, v, dt, topo,
                                             "interpret"), c))(chis)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_propagate_multi_public_entry(case):
    """`explicit_euler_propagate` on a (B, nz, ny, nx) batch equals the
    kernel's steps."""
    from otmb_tpu.models.solvers import explicit_euler_propagate

    topo, coeffs, chis = case
    dt, nsteps = 150.0, 5
    ref = jnp.asarray(chis)
    for _ in range(nsteps):
        ref = euler_step_pallas_multi(coeffs, ref, dt, topo, "interpret")
    out = explicit_euler_propagate(coeffs, chis, dt, nsteps, topo)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_multi_default_route_on_cpu(tall_case):
    """With no route given, a CPU process takes the plain path, which is
    `apply_stencil` itself."""
    topo, coeffs, chis = tall_case
    out = np.asarray(apply_stencil_pallas_multi(coeffs, chis, topo))
    np.testing.assert_array_equal(
        out, np.asarray(apply_stencil(coeffs, chis, topo)))
