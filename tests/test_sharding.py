"""Multi-device correctness: sharded pipeline == single-device pipeline.

Runs on the 8-virtual-device CPU mesh configured in conftest.py — the
standard JAX substitute for multi-chip testing (SURVEY section 4).
"""

import numpy as np
import pytest
import jax

from otmb_tpu.models.transport import assemble_transport
from otmb_tpu.ops.apply import apply_stencil
from otmb_tpu.parallel.mesh import (
    field_pspec,
    make_grid_mesh,
    shard_pytree,
    sharding_for,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_grid_mesh(jax.devices()[:8])


# The session fixtures use an 18x14 grid that does not divide over a (2,4)
# mesh; build mesh-divisible grids here instead.
@pytest.fixture(scope="module", params=["bipolar", "tripolar"])
def dataset(request):
    from otmb_tpu.utils.synthetic import synthetic_dataset

    return synthetic_dataset(nx=16, ny=8, nz=6, topology=request.param, seed=3)


@pytest.fixture(scope="module")
def gridmetrics(dataset):
    from otmb_tpu.grid.geometry import makegridmetrics

    ds = dataset
    return makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
    )


@pytest.fixture(scope="module")
def indices(gridmetrics):
    from otmb_tpu.grid.indices import makeindices

    return makeindices(gridmetrics.v3d)


def test_mesh_shape(mesh):
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("y", "x")


def test_sharded_assembly_and_apply_match(mesh, dataset, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(0)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    umo = np.nan_to_num(dataset.umo)
    vmo = np.nan_to_num(dataset.vmo)
    topo = gridmetrics.topology

    def pipeline(gm_, wet_, u, v, m, c):
        ops = assemble_transport(u, v, m, gm_, wet_)
        return apply_stencil(ops.T, c, topo)

    # single device reference
    ref = np.asarray(
        jax.jit(pipeline)(gridmetrics, indices.wet3d, umo, vmo, dataset.mlotst, chi)
    )

    # sharded: all (ny, nx)-trailing fields split over the (2, 4) mesh
    gm_sh = shard_pytree(mesh, gridmetrics)
    args_sh = [
        jax.device_put(a, sharding_for(mesh, a))
        for a in (np.asarray(indices.wet3d), umo, vmo, dataset.mlotst, chi)
    ]
    out = jax.jit(pipeline)(gm_sh, *args_sh)
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)


def test_sharded_propagation_matches(mesh, dataset, gridmetrics, indices):
    """Multi-step sharded scan (halo collectives inside the loop) agrees
    with the single-device result."""
    wet = np.asarray(indices.wet3d)
    chi = np.where(wet, 1.0, 0.0)
    topo = gridmetrics.topology
    umo = np.nan_to_num(dataset.umo)
    vmo = np.nan_to_num(dataset.vmo)

    def run(gm_, wet_, u, v, m, c):
        ops = assemble_transport(u, v, m, gm_, wet_)
        dt = 300.0

        def body(i, x):
            return x - dt * apply_stencil(ops.T, x, topo)

        return jax.lax.fori_loop(0, 20, body, c)

    ref = np.asarray(
        jax.jit(run)(gridmetrics, indices.wet3d, umo, vmo, dataset.mlotst, chi)
    )
    gm_sh = shard_pytree(mesh, gridmetrics)
    args_sh = [
        jax.device_put(a, sharding_for(mesh, a))
        for a in (np.asarray(indices.wet3d), umo, vmo, dataset.mlotst, chi)
    ]
    out = np.asarray(jax.jit(run)(gm_sh, *args_sh))
    np.testing.assert_allclose(out, ref, rtol=1e-11, atol=1e-11)


def test_halo_apply_matches_reference(mesh, dataset, gridmetrics, indices):
    """Explicit shard_map halo exchange == the dense-array apply, both
    topologies (incl. the tripolar mirror-shard fold exchange)."""
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.parallel.halo import apply_stencil_halo, euler_propagate_halo

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics, indices=indices
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics, indices=indices
    )
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(7)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    topo = gridmetrics.topology

    ref = np.asarray(apply_stencil(ops.T, chi, topo))

    coeffs_sh = shard_pytree(mesh, ops.T)
    chi_sh = jax.device_put(chi, sharding_for(mesh, chi))
    out = jax.jit(
        lambda c, x: apply_stencil_halo(c, x, topo, mesh)
    )(coeffs_sh, chi_sh)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)

    # multi-step propagation entirely inside one shard_map region
    from otmb_tpu.models.solvers import explicit_euler_propagate

    ref_prop = np.asarray(explicit_euler_propagate(ops.T, chi, 300.0, 10, topo))
    for overlap in (False, True):
        out_prop = jax.jit(
            lambda c, x, o=overlap: euler_propagate_halo(c, x, 300.0, 10, topo,
                                                         mesh, overlap=o)
        )(coeffs_sh, chi_sh)
        np.testing.assert_allclose(
            np.asarray(out_prop), ref_prop, rtol=1e-11, atol=1e-11,
            err_msg=f"overlap={overlap}",
        )


def test_field_pspec():
    assert field_pspec(3) == jax.sharding.PartitionSpec(None, "y", "x")
    assert field_pspec(2) == jax.sharding.PartitionSpec("y", "x")
    assert field_pspec(1) == jax.sharding.PartitionSpec()


def test_halo_propagate_overlap_f32(mesh, dataset, gridmetrics, indices):
    """The card's f32 arithmetic through the halo-exchange propagation,
    serialized and overlapped (interior on zero halos + boundary patch),
    against XLA's single-device propagation."""
    from otmb_tpu.models.solvers import explicit_euler_propagate
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.parallel.halo import euler_propagate_halo

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics, indices=indices
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics, indices=indices
    )
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(13)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0).astype(
        np.float32)
    topo = gridmetrics.topology
    ref = np.asarray(explicit_euler_propagate(c32, chi, np.float32(250.0), 8,
                                              topo))
    coeffs_sh = shard_pytree(mesh, c32)
    chi_sh = jax.device_put(chi, sharding_for(mesh, chi))
    for overlap in (False, True):
        out = euler_propagate_halo(coeffs_sh, chi_sh, np.float32(250.0), 8,
                                   topo, mesh, overlap=overlap)
        assert out.dtype == np.float32
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5,
                                   atol=1e-5, err_msg=f"overlap={overlap}")


def test_sharded_ideal_age_and_redi(mesh, dataset, gridmetrics, indices):
    """The Krylov ideal-age solve and the Redi operator run unchanged over
    sharded inputs (GSPMD) and agree with the single-device results."""
    from otmb_tpu.models.redi import build_redi_operator, redi_apply
    from otmb_tpu.models.solvers import ideal_age
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics, indices=indices
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics, indices=indices
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)

    ref_age, _ = ideal_age(ops.T, indices.wet3d, topo, tol=1e-11)
    coeffs_sh = shard_pytree(mesh, ops.T)
    wet_sh = jax.device_put(indices.wet3d, sharding_for(mesh, indices.wet3d))
    age_sh, res = ideal_age(coeffs_sh, wet_sh, topo, tol=1e-11)
    assert float(res) < 1e-7
    np.testing.assert_allclose(
        np.asarray(age_sh)[wet], np.asarray(ref_age)[wet], rtol=1e-6, atol=1e-3
    )

    # Redi operator sharded
    z = np.asarray(gridmetrics.z3d)
    lon = np.asarray(gridmetrics.lon)
    rho = np.where(wet, 1025.0 + 0.02 * z + 2e-4 * z * np.cos(2 * np.deg2rad(lon)),
                   np.nan)
    op = build_redi_operator(rho, gridmetrics, indices.wet3d)
    rng = np.random.default_rng(3)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    ref = np.asarray(redi_apply(op, chi))

    op_sh = shard_pytree(mesh, op)
    chi_sh = jax.device_put(chi, sharding_for(mesh, chi))
    out = redi_apply(op_sh, chi_sh)
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-10, atol=1e-12)


def test_sharded_iterative_refinement(mesh, dataset, gridmetrics, indices):
    """The mixed-precision refined solve GSPMD-partitions like the plain
    solve: f32 coefficients sharded over the mesh, f64 defect correction,
    residual below the f32 floor, matching the f64 single-device solve."""
    from otmb_tpu.models.solvers import ideal_age
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)

    ref_age, _ = ideal_age(ops.T, indices.wet3d, topo, tol=1e-11)

    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    c32_sh = shard_pytree(mesh, c32)
    wet_sh = jax.device_put(indices.wet3d, sharding_for(mesh, indices.wet3d))
    age_sh, res = ideal_age(c32_sh, wet_sh, topo, tol=1e-9, refine=True)
    assert float(res) < 1e-9
    assert len(age_sh.sharding.device_set) == 8
    np.testing.assert_allclose(
        np.asarray(age_sh)[wet], np.asarray(ref_age)[wet], rtol=1e-3, atol=1.0
    )


def test_halo_bf16_coeffs(mesh, dataset, gridmetrics, indices):
    """bf16 coefficient fields through the halo-exchange apply and
    propagation on the mesh (bf16 coefficients, f32 tracer and
    accumulation): jnp promotion widens each coefficient to f32, so the
    result matches the apply of the bf16-rounded coefficients in f32 —
    and stays within bf16 tolerance of the exact f32 result."""
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import explicit_euler_propagate
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.parallel.halo import apply_stencil_halo, euler_propagate_halo

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(17)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0).astype(
        np.float32
    )

    c_bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ops.T)
    c_rounded_f32 = jax.tree_util.tree_map(
        lambda a: a.astype(np.float32), c_bf16
    )
    ref_rounded = np.asarray(apply_stencil(c_rounded_f32, chi, topo))

    c_sh = shard_pytree(mesh, c_bf16)
    chi_sh = jax.device_put(chi, sharding_for(mesh, chi))
    out = apply_stencil_halo(c_sh, chi_sh, topo, mesh)
    assert out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out), ref_rounded, rtol=1e-5,
                               atol=1e-7)

    ref_exact = np.asarray(apply_stencil(
        jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T),
        chi, topo,
    ))
    assert np.abs(np.asarray(out) - ref_exact).max() <= (
        1e-2 * np.abs(ref_exact).max())

    ref_prop = np.asarray(explicit_euler_propagate(
        c_rounded_f32, chi, np.float32(250.0), 4, topo))
    for overlap in (False, True):
        prop = euler_propagate_halo(c_sh, chi_sh, np.float32(250.0), 4, topo,
                                    mesh, overlap=overlap)
        assert prop.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(prop), ref_prop, rtol=1e-5,
                                   atol=1e-5, err_msg=f"overlap={overlap}")


def test_sharded_krylov_halo_pallas(mesh, dataset, gridmetrics, indices):
    """The WHOLE BiCGStab loop inside one shard_map region — ppermute halo
    exchange + shard-local matvec + psum dot products — matches the
    single-device solve, forward and transpose, and `ideal_age(mesh=...)`
    runs it end to end (reference workload: test/local_full.jl:165-188)."""
    from otmb_tpu.models.solvers import (
        ideal_age,
        sequestration_time,
        solve_shifted,
    )
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)

    coeffs_sh = shard_pytree(mesh, ops.T)
    wet_sh = jax.device_put(indices.wet3d, sharding_for(mesh, indices.wet3d))

    # forward: ideal age through the sharded halo-exchange Krylov loop
    ref_age, _ = ideal_age(ops.T, indices.wet3d, topo, tol=1e-11)
    age_sh, res = ideal_age(
        coeffs_sh, wet_sh, topo, tol=1e-11, apply_impl="pallas", mesh=mesh
    )
    assert float(res) < 1e-7
    assert len(age_sh.sharding.device_set) == 8
    np.testing.assert_allclose(
        np.asarray(age_sh)[wet], np.asarray(ref_age)[wet], rtol=1e-6, atol=1e-3
    )

    # transpose: sequestration time (adjoint operator) through the same loop
    ref_seq, _ = sequestration_time(ops.T, indices.wet3d, topo, tol=1e-11)
    seq_sh, res_t = sequestration_time(
        coeffs_sh, wet_sh, topo, tol=1e-11, apply_impl="pallas", mesh=mesh
    )
    assert float(res_t) < 1e-7
    np.testing.assert_allclose(
        np.asarray(seq_sh)[wet], np.asarray(ref_seq)[wet], rtol=1e-6, atol=1e-3
    )

    # shifted solve with a generic right-hand side (implicit Euler shape)
    rng = np.random.default_rng(21)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    ref_x, _ = solve_shifted(ops.T, b, topo, shift=1e-4, tol=1e-11)
    b_sh = jax.device_put(b, sharding_for(mesh, b))
    x_sh, res_s = solve_shifted(
        coeffs_sh, b_sh, topo, shift=1e-4, tol=1e-11,
        apply_impl="pallas", mesh=mesh,
    )
    assert float(res_s) < 1e-9
    np.testing.assert_allclose(
        np.asarray(x_sh)[wet], np.asarray(ref_x)[wet], rtol=1e-6, atol=1e-6
    )


def test_sharded_krylov_overlap_matches_serial(mesh, dataset, gridmetrics,
                                               indices):
    """The comm/compute-overlapped sharded matvec (interior on zero
    halos + boundary patch) changes only edge summation order, so the
    converged solve must agree with the serialized-matvec solve."""
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.parallel.solve_halo import solve_shifted_halo

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(7)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    coeffs_sh = shard_pytree(mesh, ops.T)
    b_sh = jax.device_put(b, sharding_for(mesh, b))

    x_ser, res_ser = solve_shifted_halo(
        coeffs_sh, b_sh, topo, mesh, shift=1e-4, tol=1e-11, overlap=False
    )
    x_ovl, res_ovl = solve_shifted_halo(
        coeffs_sh, b_sh, topo, mesh, shift=1e-4, tol=1e-11, overlap=True
    )
    assert float(res_ser) < 1e-9
    assert float(res_ovl) < 1e-9
    np.testing.assert_allclose(
        np.asarray(x_ovl), np.asarray(x_ser), rtol=1e-6, atol=1e-8
    )


def test_sharded_krylov_refined(mesh, dataset, gridmetrics, indices):
    """Mixed-precision iterative refinement with the sharded halo-exchange
    inner solve: f32 Krylov inside shard_map, f64 GSPMD defect, residual
    below the f32 floor."""
    from otmb_tpu.models.solvers import ideal_age
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)

    ref_age, _ = ideal_age(ops.T, indices.wet3d, topo, tol=1e-11)

    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    c32_sh = shard_pytree(mesh, c32)
    wet_sh = jax.device_put(indices.wet3d, sharding_for(mesh, indices.wet3d))
    age_sh, res = ideal_age(
        c32_sh, wet_sh, topo, tol=1e-9, refine=True,
        apply_impl="pallas", mesh=mesh,
    )
    assert float(res) < 1e-9
    np.testing.assert_allclose(
        np.asarray(age_sh)[wet], np.asarray(ref_age)[wet], rtol=1e-3, atol=1.0
    )


def test_sharded_assembly_matches_single_device(mesh, dataset, gridmetrics,
                                               indices):
    """The mesh-partitioned assembly equals the single-device
    `assemble_transport` for both topologies, scalar and 3D rho, upwind
    and centered, and feeds the halo-exchange apply without leaving the
    mesh."""
    from otmb_tpu.parallel.assemble import assemble_T_sharded
    from otmb_tpu.parallel.halo import apply_stencil_halo

    wet = np.asarray(indices.wet3d)
    z = np.asarray(gridmetrics.z3d)
    lon = np.asarray(gridmetrics.lon)
    rho3d = np.where(
        wet, 1025.0 + 0.02 * z + 2e-4 * z * np.cos(2 * np.deg2rad(lon)), np.nan
    )
    umo = np.nan_to_num(np.asarray(dataset.umo))
    vmo = np.nan_to_num(np.asarray(dataset.vmo))
    for rho in (1035.0, rho3d):
        for upwind in (True, False):
            ref = assemble_transport(umo, vmo, dataset.mlotst, gridmetrics,
                                     indices.wet3d, rho=rho,
                                     upwind=upwind).T
            out = assemble_T_sharded(umo, vmo, dataset.mlotst, gridmetrics,
                                     mesh, rho=rho, upwind=upwind)
            assert len(out.diag.sharding.device_set) == 8
            for leg in ref._fields:
                np.testing.assert_allclose(
                    np.asarray(getattr(out, leg)),
                    np.asarray(getattr(ref, leg)), rtol=1e-12, atol=1e-20,
                    err_msg=f"leg={leg} upwind={upwind} "
                            f"rho3d={np.ndim(rho) == 3}",
                )

    topo = gridmetrics.topology
    rng = np.random.default_rng(11)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    coeffs_sh = assemble_T_sharded(umo, vmo, dataset.mlotst, gridmetrics, mesh)
    out = apply_stencil_halo(
        coeffs_sh, jax.device_put(chi, sharding_for(mesh, chi)), topo, mesh,
    )
    ref_c = assemble_transport(umo, vmo, dataset.mlotst, gridmetrics,
                               indices.wet3d).T
    ref = np.asarray(apply_stencil(ref_c, chi, topo))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-14)


def test_sharded_redi_bf16_matches_single_device(mesh, dataset, gridmetrics,
                                                 indices):
    """The Redi apply with bf16 coefficient fields, partitioned by XLA
    over the mesh, equals the single-device bf16 apply."""
    from otmb_tpu.models.redi import (
        build_redi_operator,
        redi_apply,
        redi_operator_to_bf16,
    )

    wet = np.asarray(indices.wet3d)
    z = np.asarray(gridmetrics.z3d)
    lon = np.asarray(gridmetrics.lon)
    rho = np.where(
        wet, 1025.0 + 0.02 * z + 2e-4 * z * np.cos(2 * np.deg2rad(lon)), np.nan
    )
    op = redi_operator_to_bf16(build_redi_operator(rho, gridmetrics,
                                                   indices.wet3d))
    rng = np.random.default_rng(5)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0).astype(
        np.float32)
    ref = np.asarray(redi_apply(op, chi))
    out = redi_apply(shard_pytree(mesh, op),
                     jax.device_put(chi, sharding_for(mesh, chi)))
    assert len(out.sharding.device_set) == 8
    assert out.dtype == np.float32
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("transpose", [False, True])
def test_sharded_multi_solve_matches_single(mesh, dataset, gridmetrics,
                                            indices, transpose):
    """The batched lockstep solve on the plain path, partitioned by XLA
    over the mesh (water-mass fractions of a two-region partition, and
    their adjoint), against the single-device batched solve."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from otmb_tpu.models.solvers import solve_shifted_multi
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    surf = np.zeros(wet.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    ny = wet.shape[1]
    masks = np.zeros((2,) + wet.shape[1:], bool)
    masks[0, : ny // 2] = True
    masks[1, ny // 2:] = True
    bs = np.where(wet[None] & masks[:, None], surf[None], 0.0)
    bs_sh = jax.device_put(bs, NamedSharding(mesh, P(None, None, "y", "x")))
    surf_sh = jax.device_put(surf, sharding_for(mesh, surf))
    x_sh, res = solve_shifted_multi(
        shard_pytree(mesh, ops.T), bs_sh, topo, extra_diag=surf_sh, tol=1e-11,
        transpose=transpose, apply_impl="jnp",
    )
    assert float(np.max(np.asarray(res))) < 1e-9
    assert len(x_sh.sharding.device_set) == 8
    x_ref, _ = solve_shifted_multi(ops.T, bs, topo, extra_diag=surf,
                                   tol=1e-11, transpose=transpose,
                                   apply_impl="jnp")
    np.testing.assert_allclose(np.asarray(x_sh)[:, wet],
                               np.asarray(x_ref)[:, wet], rtol=1e-3,
                               atol=1e-6)


def test_sharded_ir_bf16_narrow(mesh, dataset, gridmetrics, indices):
    """bf16-narrow iterative refinement with the SHARDED inner solve:
    bf16 coefficient fields through the shard_map halo-exchange Krylov,
    f32 Krylov vectors, f64 defect correction — residual reaches far
    below both bf16 and f32 floors against the promoted bf16 operator."""
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import solve_shifted_ir
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)

    c16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ops.T)
    c16_sh = shard_pytree(mesh, c16)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(wet.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    b_sh = jax.device_put(ones, sharding_for(mesh, ones))
    surf_sh = jax.device_put(surf, sharding_for(mesh, surf))

    x, res = solve_shifted_ir(
        c16_sh, b_sh, topo, extra_diag=surf_sh, tol=1e-9,
        max_refinements=25, apply_impl="pallas", mesh=mesh,
    )
    assert float(res) < 1e-9
    assert x.dtype == jnp.float64

    # agrees with the unsharded bf16-narrow refined solve
    x_ref, res_ref = solve_shifted_ir(
        c16, ones, topo, extra_diag=surf, tol=1e-9, max_refinements=25,
    )
    assert float(res_ref) < 1e-9
    np.testing.assert_allclose(
        np.asarray(x)[wet], np.asarray(x_ref)[wet], rtol=1e-6, atol=1e-4
    )


@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
def test_sharded_chunked_krylov_matches_single_device(
        mesh, dataset, gridmetrics, indices, algorithm):
    """The sharded fori-chunked Krylov (parallel/solve_halo_chunked.py),
    the mesh engine for large shards, matches the single-device solve,
    forward and transpose, with stats populated."""
    from otmb_tpu.models.solvers import solve_shifted
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.parallel.solve_halo_chunked import (
        solve_shifted_halo_chunked,
    )

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(31)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    coeffs_sh = shard_pytree(mesh, ops.T)
    b_sh = jax.device_put(b, sharding_for(mesh, b))
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    surf_sh = jax.device_put(surf, sharding_for(mesh, surf))

    for transpose in (False, True):
        ref_x, _ = solve_shifted(
            ops.T, b, topo, shift=1e-4, extra_diag=surf, tol=1e-11,
            transpose=transpose,
        )
        stats = {}
        x_sh, res = solve_shifted_halo_chunked(
            coeffs_sh, b_sh, topo, mesh, shift=1e-4, extra_diag=surf_sh,
            tol=1e-10, chunk=20, transpose=transpose,
            algorithm=algorithm, stats=stats,
        )
        assert float(res) < 1e-8
        assert stats["stop"] == "converged"
        assert 0 < stats["iters"] <= 2000
        assert len(x_sh.sharding.device_set) == 8
        np.testing.assert_allclose(
            np.asarray(x_sh)[wet], np.asarray(ref_x)[wet],
            rtol=1e-5, atol=1e-7,
        )


def test_sharded_ir_over_halo_chunked_inner(mesh, dataset, gridmetrics,
                                            indices, monkeypatch):
    """The production mesh refinement composition: solve_shifted_ir
    routes its inner f32 solves through the sharded fori-chunked engine
    when the per-shard grid is large (forced here by lowering the size
    threshold), and still converges below the f32 floor."""
    from otmb_tpu.models import solvers as S
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport

    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    coeffs_sh = shard_pytree(mesh, c32)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    ones_sh = jax.device_put(ones.astype(np.float32),
                             sharding_for(mesh, ones))
    surf_sh = jax.device_put(surf.astype(np.float32),
                             sharding_for(mesh, surf))

    monkeypatch.setattr(S, "CHUNKED_MIN_COLUMNS", 1)
    import otmb_tpu.parallel.solve_halo_chunked as HC

    calls = {"n": 0}
    real = HC.solve_shifted_halo_chunked

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(HC, "solve_shifted_halo_chunked", spy)
    stt = {}
    x, rel = S.solve_shifted_ir(
        coeffs_sh, ones_sh, topo, extra_diag=surf_sh, tol=1e-9,
        apply_impl="pallas", mesh=mesh, stats=stt,
    )
    assert calls["n"] >= 1  # the sharded chunked engine actually ran
    assert float(rel) < 1e-9
    assert stt["passes"][0]["inner_stop"] is not None
    ref, _ = S.ideal_age(ops.T, indices.wet3d, topo, tol=1e-11)
    np.testing.assert_allclose(
        np.asarray(x)[wet], np.asarray(ref)[wet], rtol=1e-5, atol=1e-3,
    )


def test_use_halo_chunked_predicate(mesh):
    """Routing predicate: mesh solves switch to the sharded chunked
    engine exactly when the PER-SHARD grid reaches the size rule
    (`solvers.CHUNKED_MIN_COLUMNS`)."""
    from otmb_tpu.grid.topology import GridTopology
    from otmb_tpu.models import solvers as S

    # 0.1-degree-class grid: per-shard planes over a (2,4) mesh are
    # 900 x 1350 = 1.2M columns. The 0.25-degree grid over 8 devices
    # gives 540 x 360 shards and stays on the while_loop halo engine.
    huge = GridTopology(kind="tripolar", nx=3600, ny=2700, nz=75)
    quarter = GridTopology(kind="tripolar", nx=1440, ny=1080, nz=75)
    small = GridTopology(kind="tripolar", nx=16, ny=8, nz=6)
    assert S._use_halo_chunked("pallas", mesh, False, huge)
    assert not S._use_halo_chunked("pallas", mesh, False, quarter)
    assert not S._use_halo_chunked("pallas", mesh, False, small)
    assert not S._use_halo_chunked("pallas", None, False, huge)
    assert not S._use_halo_chunked("pallas", mesh, True, huge)
    assert not S._use_halo_chunked("jnp", mesh, False, huge)
    # single device: the whole 0.25-degree plane takes the chunked engine
    assert S._use_chunked("pallas", None, False, quarter)
    assert not S._use_chunked("pallas", mesh, False, quarter)
