"""Built-in TEOS-10 polynomial equation of state (physics/eos.py).

Validates the polyTEOS10-bsq fit against the published check value and
physical-oceanography derivative magnitudes (via autodiff), then runs
the reference's full density pipeline end-to-end: thetao/so -> rho ->
locally-referenced potential-density slopes -> GM bolus -> transport
operator (mirrors test/LocalBuiltMatrix.jl:71-72 + RediGM.jl:17-35,
which the reference can only run with the external GibbsSeaWater
package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from otmb_tpu.physics.eos import linear_eos, rho_teos10, sigma0_teos10


def test_published_check_value():
    """Roquet et al. 2015, polyTEOS10-bsq check value:
    rho(SA=30 g/kg, CT=10 C, z=-1000 m) = 1027.45140 kg/m^3."""
    r = float(rho_teos10(30.0, 10.0, 1000.0))
    assert abs(r - 1027.45140) < 1e-4


def test_surface_sigma0_range():
    # standard seawater: sigma0(35, 15) ~ 25.97, sigma0(30, 10) ~ 22.96
    assert abs(float(sigma0_teos10(30.0, 10.0)) - 22.957) < 0.01
    assert abs(float(sigma0_teos10(35.0, 15.0)) - 25.848) < 0.01


def test_derivative_coefficients_via_autodiff():
    """Thermal expansion alpha = -(1/rho) drho/dCT and haline
    contraction beta = (1/rho) drho/dSA at (35 g/kg, 15 C, surface)
    must match the literature values (~2.1e-4 /K, ~7.4e-4 kg/g)."""
    r = float(rho_teos10(35.0, 15.0, 0.0))
    a = -float(jax.grad(lambda ct: rho_teos10(35.0, ct, 0.0))(15.0)) / r
    b = float(jax.grad(lambda sa: rho_teos10(sa, 15.0, 0.0))(35.0)) / r
    assert 1.9e-4 < a < 2.3e-4
    assert 7.0e-4 < b < 7.8e-4


def test_monotonicity_and_compressibility():
    sa = jnp.linspace(5.0, 40.0, 20)
    r_sa = rho_teos10(sa, 10.0, 0.0)
    assert bool(jnp.all(jnp.diff(r_sa) > 0))  # saltier is denser

    ct = jnp.linspace(6.0, 30.0, 20)
    r_ct = rho_teos10(35.0, ct, 0.0)
    assert bool(jnp.all(jnp.diff(r_ct) < 0))  # warmer is lighter

    z = jnp.linspace(0.0, 5000.0, 20)
    r_z = rho_teos10(35.0, 5.0, z)
    assert bool(jnp.all(jnp.diff(r_z) > 0))  # deeper is denser
    # Boussinesq compressibility ~ 4.4-4.8 kg/m^3 per km near surface
    dr_km = float(r_z[4] - r_z[0]) / float(z[4] - z[0]) * 1000.0
    assert 4.0 < dr_km < 5.2


def test_f32_consistency_and_jit():
    """The f32 evaluation (the accelerator path) stays within f32 roundoff of
    f64, and the function jits cleanly."""
    rng = np.random.default_rng(3)
    sa = rng.uniform(30, 38, (4, 5)).astype(np.float64)
    ct = rng.uniform(-1, 25, (4, 5)).astype(np.float64)
    z = rng.uniform(0, 4000, (4, 5)).astype(np.float64)
    r64 = np.asarray(rho_teos10(sa, ct, z))
    r32 = np.asarray(jax.jit(rho_teos10)(
        sa.astype(np.float32), ct.astype(np.float32), z.astype(np.float32)
    ))
    np.testing.assert_allclose(r32, r64, rtol=2e-6)


def test_linear_eos_factory():
    eos = linear_eos(rho0=1000.0, alpha=2e-4, beta=8e-4, ct0=10.0, sa0=35.0)
    assert float(eos(35.0, 10.0, 123.0)) == pytest.approx(1000.0)
    assert float(eos(35.0, 11.0, 0.0)) == pytest.approx(1000.0 * (1 - 2e-4))
    assert float(eos(36.0, 10.0, 0.0)) == pytest.approx(1000.0 * (1 + 8e-4))


def test_density_pipeline_end_to_end(dataset, gridmetrics, indices):
    """thetao/so -> rho_teos10 -> locally-referenced potential-density
    slopes -> GM bolus -> operator, with volume conservation preserved
    (the invariant the reference pins for every operator,
    test/online.jl:114-117)."""
    import otmb_tpu as otmb

    gm, idx, ds = gridmetrics, indices, dataset
    wet = jnp.asarray(np.asarray(idx.wet3d))
    # T and S varying in BOTH horizontal directions and depth, so both
    # slope components are exercised.
    so = jnp.where(wet, 35.0 + 0.2 * jnp.cos(jnp.deg2rad(gm.lat))
                   * jnp.sin(jnp.deg2rad(gm.lon)), jnp.nan)
    ct = jnp.where(
        wet,
        18.0 - 0.004 * gm.z3d + 0.5 * jnp.sin(jnp.deg2rad(gm.lat)),
        jnp.nan,
    )
    rho = otmb.rho_teos10(so, ct, gm.z3d)
    assert float(jnp.nanmin(rho)) > 1020 and float(jnp.nanmax(rho)) < 1045

    s_i, s_j = otmb.potential_density_slopes(
        otmb.rho_teos10, so, ct, gm, idx.wet3d
    )
    finite_i = jnp.isfinite(s_i)
    assert float(jnp.max(jnp.abs(jnp.where(finite_i, s_i, 0.0)))) > 0

    umo2, vmo2 = otmb.add_bolus_transports(
        ds.umo, ds.vmo, rho, gm, idx.wet3d
    )
    phi = otmb.facefluxesfrommasstransport(
        umo=umo2, vmo=vmo2, gridmetrics=gm, indices=idx
    )
    ops = otmb.transportmatrix(
        phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx
    )
    diag = otmb.operator_diagnostics(ops.T, gm.v3d, idx.wet3d, gm.topology)
    myr = 86400 * 365.25 * 1e6
    assert diag["tau_vol_s"] / myr > 1.0  # volume conservation > 1 Myr
