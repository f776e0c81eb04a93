"""The jittable assembly `assemble_transport(...).T` (XLA's path, single
device and partitioned over a mesh) against the host pipeline
`transportmatrix`, which test_operator_parity.py checks against literal
reference loops — for both topologies, both advection schemes, f64 and
f32, scalar and 3D density, and non-default mixing coefficients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from otmb_tpu.models.transport import assemble_transport, transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
from otmb_tpu.parallel.assemble import assemble_T_sharded
from otmb_tpu.parallel.mesh import make_grid_mesh


def _pipeline_T(dataset, gridmetrics, indices, **kw):
    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
        indices=indices,
    )
    return transportmatrix(phi=phi, mlotst=dataset.mlotst,
                           gridmetrics=gridmetrics, indices=indices, **kw).T


def _jit_T(dataset, gridmetrics, indices, **kw):
    return jax.jit(lambda u, v, m: assemble_transport(
        u, v, m, gridmetrics, indices.wet3d, **kw).T)(
        jnp.nan_to_num(jnp.asarray(dataset.umo)),
        jnp.nan_to_num(jnp.asarray(dataset.vmo)),
        jnp.asarray(dataset.mlotst),
    )


def _assert_legs(out, ref, rtol=1e-12, atol=1e-18):
    for leg in ref._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(out, leg)), np.asarray(getattr(ref, leg)),
            rtol=rtol, atol=atol, err_msg=leg,
        )


def _rho3d(gridmetrics, indices):
    """A laterally- and vertically-varying density, NaN on land (the
    reference's main rho mode, matrixbuilding.jl:221-225)."""
    return jnp.where(
        indices.wet3d,
        1030.0 + 0.01 * gridmetrics.z3d
        + 0.5 * jnp.cos(2 * jnp.deg2rad(gridmetrics.lon))
        + 0.3 * jnp.sin(3 * jnp.deg2rad(gridmetrics.lat)),
        jnp.nan,
    )


@pytest.mark.parametrize("upwind", [True, False], ids=["upwind", "centered"])
def test_jit_assembly_matches_pipeline(dataset, gridmetrics, indices, upwind):
    _assert_legs(_jit_T(dataset, gridmetrics, indices, upwind=upwind),
                 _pipeline_T(dataset, gridmetrics, indices, upwind=upwind))


def test_jit_assembly_f32(dataset, gridmetrics, indices):
    """The card's path runs float32; agreement at f32 tolerances."""
    gm32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if hasattr(x, "astype") else x,
        gridmetrics,
    )
    umo = jnp.nan_to_num(jnp.asarray(dataset.umo, jnp.float32))
    vmo = jnp.nan_to_num(jnp.asarray(dataset.vmo, jnp.float32))
    ml = jnp.asarray(dataset.mlotst, jnp.float32)
    out = assemble_transport(umo, vmo, ml, gm32, indices.wet3d).T
    assert out.diag.dtype == jnp.float32
    _assert_legs(out, _pipeline_T(dataset, gridmetrics, indices),
                 rtol=2e-5, atol=1e-12)


def test_sharded_assembly_default_wet_mask(dataset, gridmetrics, indices):
    """wet3d=None means the cells of finite volume (the makeindices
    convention)."""
    mesh = make_grid_mesh(jax.devices()[:1])
    umo = jnp.nan_to_num(jnp.asarray(dataset.umo))
    vmo = jnp.nan_to_num(jnp.asarray(dataset.vmo))
    a = assemble_T_sharded(umo, vmo, dataset.mlotst, gridmetrics, mesh)
    b = assemble_T_sharded(umo, vmo, dataset.mlotst, gridmetrics, mesh,
                           wet3d=indices.wet3d)
    _assert_legs(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("upwind", [True, False], ids=["upwind", "centered"])
@pytest.mark.parametrize("kappas", [(300.0, 1.0, 1e-4), (2000.0, 0.05, 3e-5)],
                         ids=["weak", "strong"])
def test_jit_assembly_mixing_coefficients(dataset, gridmetrics, indices,
                                          upwind, kappas):
    kh, kml, kdeep = kappas
    kw = dict(kappa_h=kh, kappa_vml=kml, kappa_vdeep=kdeep, upwind=upwind)
    _assert_legs(_jit_T(dataset, gridmetrics, indices, **kw),
                 _pipeline_T(dataset, gridmetrics, indices, **kw))


@pytest.mark.parametrize("upwind", [True, False], ids=["upwind", "centered"])
def test_jit_assembly_3d_rho(dataset, gridmetrics, indices, upwind):
    rho3d = _rho3d(gridmetrics, indices)
    _assert_legs(
        _jit_T(dataset, gridmetrics, indices, rho=rho3d, upwind=upwind),
        _pipeline_T(dataset, gridmetrics, indices, rho=rho3d, upwind=upwind),
    )


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
def test_sharded_assembly_3d_rho(dataset, gridmetrics, indices, mesh_shape):
    """3D density through the mesh-partitioned assembly, split in j (the
    tripolar fold crosses shards) and in i (the periodic wrap does)."""
    mesh = make_grid_mesh(jax.devices()[:2], mesh_shape=mesh_shape)
    rho3d = _rho3d(gridmetrics, indices)
    out = assemble_T_sharded(
        jnp.nan_to_num(jnp.asarray(dataset.umo)),
        jnp.nan_to_num(jnp.asarray(dataset.vmo)),
        dataset.mlotst, gridmetrics, mesh, wet3d=indices.wet3d, rho=rho3d,
    )
    assert out.diag.sharding.mesh.shape == dict(zip(("y", "x"), mesh_shape))
    _assert_legs(out, _pipeline_T(dataset, gridmetrics, indices, rho=rho3d))


def test_jit_assembly_traced_kappa(dataset, gridmetrics, indices):
    """Traced physics scalars (jit-compatible assembly with swept
    parameters) agree with the pipeline."""
    umo = jnp.nan_to_num(jnp.asarray(dataset.umo))
    vmo = jnp.nan_to_num(jnp.asarray(dataset.vmo))
    ref = _pipeline_T(dataset, gridmetrics, indices, kappa_h=750.0)
    out = jax.jit(
        lambda kh: assemble_transport(
            umo, vmo, dataset.mlotst, gridmetrics, indices.wet3d,
            kappa_h=kh,
        ).T
    )(750.0)
    _assert_legs(out, ref)
