"""Redi isoneutral diffusion operator: conservation, null space, and the
zero-slope reduction to horizontal diffusion."""

import numpy as np
import pytest

from otmb_tpu.models.redi import build_redi_operator, redi_apply
from otmb_tpu.ops.apply import apply_stencil
from otmb_tpu.ops.coeffs import horizontal_diffusion_coeffs


@pytest.fixture(scope="module")
def rho(gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    z = np.asarray(gridmetrics.z3d)
    lon = np.asarray(gridmetrics.lon)
    lat = np.asarray(gridmetrics.lat)
    return np.where(
        wet,
        1025.0
        + 0.02 * z
        + 2e-4 * z * np.cos(2 * np.deg2rad(lon))
        + 1e-4 * z * np.sin(np.deg2rad(lat)),
        np.nan,
    )


@pytest.fixture(scope="module")
def redi_op(rho, gridmetrics, indices):
    return build_redi_operator(rho, gridmetrics, indices.wet3d, kappa_redi=600.0)


def test_conserves_tracer(redi_op, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(0)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    tend = np.asarray(redi_apply(redi_op, chi))
    assert np.isfinite(tend).all()
    assert np.all(tend[~wet] == 0.0)

    v = np.where(wet, np.asarray(gridmetrics.v3d), 0.0)
    total = float((tend * v).sum())
    scale = float(np.abs(tend * v).sum())
    assert abs(total) < 1e-10 * max(scale, 1e-300)


def test_constant_in_null_space(redi_op, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    chi = np.where(wet, 7.5, 0.0)
    tend = np.asarray(redi_apply(redi_op, chi))
    assert np.abs(tend).max() < 1e-12


def test_linearity(redi_op, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(1)
    x = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    y = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    lhs = np.asarray(redi_apply(redi_op, 2.0 * x - 3.0 * y))
    rhs = 2.0 * np.asarray(redi_apply(redi_op, x)) - 3.0 * np.asarray(
        redi_apply(redi_op, y)
    )
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10, atol=1e-18)


def test_zero_slope_reduces_to_horizontal_diffusion(gridmetrics, indices):
    """With a purely z-dependent density, the slopes vanish and the Redi
    operator must equal minus the horizontal-diffusion stencil with the
    same kappa (identical min-face-area and distance rules)."""
    wet = np.asarray(indices.wet3d)
    z = np.asarray(gridmetrics.z3d)
    rho_z = np.where(wet, 1025.0 + 0.02 * z, np.nan)
    op = build_redi_operator(rho_z, gridmetrics, indices.wet3d, kappa_redi=500.0)
    assert float(np.abs(np.asarray(op.s_e)).max()) < 1e-12
    assert float(np.abs(np.asarray(op.s_ti)).max()) < 1e-12

    rng = np.random.default_rng(2)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    tend = np.asarray(redi_apply(op, chi))

    kh = horizontal_diffusion_coeffs(gridmetrics, indices.wet3d, 500.0)
    expected = -np.asarray(apply_stencil(kh, chi, gridmetrics.topology))
    np.testing.assert_allclose(tend, expected, rtol=1e-9, atol=1e-12)


def test_isoneutral_suppression(rho, redi_op, gridmetrics, indices):
    """A tracer that is a function of density diffuses far less than a
    generic tracer of similar gradient magnitude (the whole point of the
    rotated tensor)."""
    wet = np.asarray(indices.wet3d)
    rho_w = np.where(wet, rho, 0.0)
    aligned = rho_w - np.where(wet, 1025.0, 0.0)  # linear function of rho
    tend_aligned = np.asarray(redi_apply(redi_op, np.where(wet, aligned, 0.0)))

    # misaligned tracer: pure depth dependence with matched scale
    z = np.asarray(gridmetrics.z3d)
    mis = np.where(wet, 0.02 * z, 0.0)
    tend_mis = np.asarray(redi_apply(redi_op, mis))

    v = np.where(wet, np.asarray(gridmetrics.v3d), 0.0)
    norm = lambda t: float(np.sqrt((t**2 * v).sum()))
    # not zero (discrete truncation + taper), but clearly suppressed
    assert norm(tend_aligned) < 0.8 * norm(tend_mis)


def test_redi_batched_matches_single(redi_op, gridmetrics, indices):
    """A batch of tracers through `redi_apply` under vmap reproduces each
    member's own apply (the batched path that replaced the multi-tracer
    kernel)."""
    import jax

    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(14)
    chis = np.where(wet[None], 1.0 + rng.standard_normal((3,) + wet.shape),
                    0.0)
    got = np.asarray(jax.vmap(redi_apply, in_axes=(None, 0))(redi_op, chis))
    assert got.shape == chis.shape
    for b in range(3):
        ref = np.asarray(redi_apply(redi_op, chis[b]))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[b], ref, rtol=1e-12,
                                   atol=1e-12 * scale)


def test_redi_conserves_and_kills_constants_f32(redi_op, gridmetrics,
                                                indices):
    """The invariants hold in the card's f32 arithmetic: the
    volume-integrated tendency vanishes to f32 rounding and constants
    stay in the null space."""
    import dataclasses

    from otmb_tpu.models.redi import _COEF_FIELDS

    op32 = dataclasses.replace(
        redi_op,
        **{k: getattr(redi_op, k).astype(np.float32) for k in _COEF_FIELDS},
    )
    wet = np.asarray(indices.wet3d)
    v = np.where(wet, np.asarray(gridmetrics.v3d), 0.0)
    rng = np.random.default_rng(12)
    chi = np.where(wet, 1.0 + 0.5 * rng.standard_normal(wet.shape),
                   0.0).astype(np.float32)
    tend = np.asarray(redi_apply(op32, chi), np.float64)
    assert tend.dtype == np.float64
    total = float(np.sum(tend * v))
    scale = float(np.sum(np.abs(tend) * v)) or 1.0
    assert abs(total) / scale < 1e-5

    const = np.where(wet, 3.0, 0.0).astype(np.float32)
    t0 = np.asarray(redi_apply(op32, const))
    ref = np.asarray(redi_apply(redi_op, chi))
    assert np.abs(t0[wet]).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
def test_redi_sharded_matches_single(redi_op, gridmetrics, indices,
                                     mesh_shape):
    """`redi_apply` on mesh-sharded operator and tracer (XLA partitions
    it; j split crosses the tripolar fold, i split the periodic wrap)
    equals the single-device apply."""
    import jax

    from otmb_tpu.parallel.mesh import make_grid_mesh, shard_pytree

    mesh = make_grid_mesh(jax.devices()[:2], mesh_shape=mesh_shape)
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(13)
    chi = np.where(wet, 1.0 + rng.standard_normal(gridmetrics.shape), 0.0)
    ref = np.asarray(redi_apply(redi_op, chi))
    got = redi_apply(shard_pytree(mesh, redi_op), shard_pytree(mesh, chi))
    assert len(got.sharding.device_set) == 2
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12,
                               atol=1e-12 * scale)


def test_redi_linear_in_kappa(rho, gridmetrics, indices):
    """The tendency scales with kappa_redi (the slopes, taper and masks do
    not depend on it)."""
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(17)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    t1 = np.asarray(redi_apply(
        build_redi_operator(rho, gridmetrics, indices.wet3d, kappa_redi=500.0),
        chi))
    t2 = np.asarray(redi_apply(
        build_redi_operator(rho, gridmetrics, indices.wet3d,
                            kappa_redi=1500.0), chi))
    np.testing.assert_allclose(t2, 3.0 * t1, rtol=1e-10,
                               atol=1e-12 * np.abs(t2).max())


def test_redi_bf16_coefficients(redi_op, indices):
    """bf16 coefficient fields: the output matches the apply of the
    bf16-rounded operator in f32 (the coefficients are widened inside the
    fused arithmetic), and the rounding stays at the bf16 level."""
    import dataclasses

    import jax.numpy as jnp

    from otmb_tpu.models.redi import _COEF_FIELDS, redi_operator_to_bf16

    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(16)
    chi = np.where(wet, 1.0 + rng.standard_normal(wet.shape), 0.0).astype(
        np.float32
    )

    op_bf16 = redi_operator_to_bf16(redi_op)
    assert op_bf16.ae.dtype == jnp.bfloat16

    op_rt = dataclasses.replace(
        redi_op,
        **{
            k: getattr(op_bf16, k).astype(np.float32)
            for k in _COEF_FIELDS
        },
    )
    ref = np.asarray(redi_apply(op_rt, chi)).astype(np.float32)
    got = np.asarray(redi_apply(op_bf16, chi))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    exact = np.asarray(redi_apply(redi_op, chi))
    assert np.abs(got - exact).max() <= 3e-2 * np.abs(exact).max()
