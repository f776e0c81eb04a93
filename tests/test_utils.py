"""IO conversion, checkpointing, profiling harness, sequestration time,
and GM bolus composition."""

import numpy as np
import pytest

from otmb_tpu.models.transport import transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
from otmb_tpu.utils.io import from_reference_order, to_reference_order


@pytest.fixture(scope="module")
def ops(dataset, gridmetrics, indices):
    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics, indices=indices
    )
    return transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics, indices=indices
    )


def test_reference_order_roundtrip():
    rng = np.random.default_rng(0)
    a3 = rng.standard_normal((5, 6, 7))  # (nx, ny, nz) reference order
    c = from_reference_order(a3)
    assert c.shape == (7, 6, 5)
    np.testing.assert_array_equal(to_reference_order(c), a3)
    # Memory order equivalence: Julia column-major (i fastest) == numpy
    # C-order (nz, ny, nx) with i last
    np.testing.assert_array_equal(
        np.asfortranarray(a3).ravel(order="F"), c.ravel(order="C")
    )

    a2 = rng.standard_normal((5, 6))
    assert from_reference_order(a2).shape == (6, 5)
    av = rng.standard_normal((4, 5, 6))  # (4, nx, ny)
    assert from_reference_order(av).shape == (4, 6, 5)


def test_checkpoint_roundtrip(tmp_path, ops, gridmetrics, indices):
    from otmb_tpu.utils.checkpoint import (
        load_operator,
        load_state,
        save_operator,
        save_state,
    )

    path = tmp_path / "op.npz"
    chi = np.where(np.asarray(indices.wet3d), 2.0, 0.0)
    save_operator(path, ops.T, gridmetrics.topology, chi=chi)
    coeffs, topo, extras = load_operator(path)
    assert topo == gridmetrics.topology
    np.testing.assert_array_equal(np.asarray(coeffs.diag), np.asarray(ops.T.diag))
    np.testing.assert_array_equal(extras["chi"], chi)

    spath = tmp_path / "state.npz"
    save_state(spath, chi=chi, step=np.int64(17))
    state = load_state(spath)
    assert int(state["step"]) == 17


def test_profiling_harness(ops, gridmetrics, indices):
    from otmb_tpu.ops.apply import apply_stencil
    from otmb_tpu.utils.profiling import roofline_report, stencil_bytes

    wet = np.asarray(indices.wet3d)
    chi = np.where(wet, 1.0, 0.0)
    rep = roofline_report(
        lambda c: c - 100.0 * apply_stencil(ops.T, c, gridmetrics.topology),
        chi,
        stencil_bytes(gridmetrics.shape, 8),
        nsteps=10,
    )
    assert rep.seconds_per_step > 0
    assert rep.achieved_gbps > 0
    assert rep.fraction_of_peak is None  # no device kind, no share
    assert "steps/s" in str(rep)


def test_sequestration_time(ops, gridmetrics, indices):
    """Adjoint workload: (T' + M) x = 1. Volume-weighted mean sequestration
    time equals volume-weighted mean ideal age (both equal the full
    volume-integrated residence identity for the same surface sink)."""
    from otmb_tpu.models.solvers import ideal_age, sequestration_time

    wet = np.asarray(indices.wet3d)
    gamma_a, res_a = ideal_age(ops.T, indices.wet3d, gridmetrics.topology, tol=1e-12)
    gamma_s, res_s = sequestration_time(
        ops.T, indices.wet3d, gridmetrics.topology, tol=1e-12
    )
    assert float(res_s) < 1e-6
    gamma_s = np.asarray(gamma_s)
    assert np.isfinite(gamma_s[wet]).all()
    assert (gamma_s[wet] > 0).all()


def test_gm_bolus_composition(dataset, gridmetrics, indices):
    """GM bolus transports folded into umo/vmo must keep the operator
    conservative (the closure re-balances the vertical fluxes)."""
    from otmb_tpu.models.redigm import add_bolus_transports
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.apply import operator_diagnostics

    wet = np.asarray(indices.wet3d)
    z = np.asarray(gridmetrics.z3d)
    lon = np.asarray(gridmetrics.lon)
    rho = np.where(
        wet, 1025.0 + 0.02 * z + 1e-4 * z * np.cos(2 * np.deg2rad(lon)), np.nan
    )

    umo2, vmo2 = add_bolus_transports(
        np.nan_to_num(dataset.umo), np.nan_to_num(dataset.vmo), rho, gridmetrics,
        wet,
    )
    umo2, vmo2 = np.asarray(umo2), np.asarray(vmo2)
    assert not np.allclose(umo2, np.nan_to_num(dataset.umo))  # bolus nonzero

    phi = facefluxesfrommasstransport(
        umo=umo2, vmo=vmo2, gridmetrics=gridmetrics, indices=indices
    )
    ops2 = transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics, indices=indices
    )
    d = operator_diagnostics(ops2.Tadv, np.asarray(gridmetrics.v3d), wet,
                             gridmetrics.topology)
    myr = 1e6 * 365.25 * 24 * 3600
    assert float(d["tau_vol_s"]) / myr > 1e4  # volume conservation survives


def test_synthetic_device_case_matches_host_geometry():
    """Device-generated benchmark case must agree with the host pipeline's
    geometry, and its assembled operator must satisfy the conservation
    invariants."""
    import jax.numpy as jnp

    from otmb_tpu.grid.geometry import makegridmetrics
    from otmb_tpu.models.transport import assemble_transport
    from otmb_tpu.ops.apply import operator_diagnostics
    from otmb_tpu.utils.synthetic import synthetic_dataset, synthetic_device_case

    nx, ny, nz = 24, 16, 8
    gm_d, wet_d, umo_d, vmo_d, ml_d = synthetic_device_case(
        nx, ny, nz, topology="tripolar", dtype=jnp.float64, seed=0
    )
    ds = synthetic_dataset(nx=nx, ny=ny, nz=nz, topology="tripolar", seed=0)
    gm_h = makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
    )
    assert gm_d.topology == gm_h.topology
    np.testing.assert_array_equal(np.asarray(wet_d), ds.wet3d)
    np.testing.assert_allclose(
        np.asarray(gm_d.edge_length.east), np.asarray(gm_h.edge_length.east),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(gm_d.v3d)[np.asarray(wet_d)],
        np.asarray(gm_h.v3d)[ds.wet3d],
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(gm_d.z3d)[np.asarray(wet_d)],
        np.asarray(gm_h.z3d)[ds.wet3d],
        rtol=1e-12,
    )

    ops = assemble_transport(umo_d, vmo_d, ml_d, gm_d, wet_d)
    d = operator_diagnostics(ops.Tadv, gm_d.v3d, wet_d, gm_d.topology)
    myr = 1e6 * 365.25 * 24 * 3600
    assert float(d["tau_vol_s"]) / myr > 1e4
