"""The single-tracer stencil: the batched kernel at B = 1 (Pallas
interpreter on CPU) and XLA's plain path (`apply_stencil`,
`explicit_euler_propagate`) against the wet-cell sparse matrix."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from otmb_tpu.models.solvers import explicit_euler_propagate
from otmb_tpu.models.transport import transportmatrix
from otmb_tpu.ops.apply import apply_stencil
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
from otmb_tpu.ops.stencil_pallas import (
    apply_stencil_pallas_multi,
    euler_step_pallas_multi,
)
from otmb_tpu.utils.sparse_export import coeffs_to_scipy


@pytest.fixture(scope="module")
def ops(dataset, gridmetrics, indices):
    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics, indices=indices
    )
    return transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics, indices=indices
    )


def _kernel_apply(coeffs, chi, topo):
    return np.asarray(
        apply_stencil_pallas_multi(coeffs, jnp.asarray(chi)[None], topo,
                                   "interpret")[0])


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda x: x.astype(dtype), tree)


def test_pallas_apply_matches_reference(ops, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(0)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)

    ref = np.asarray(apply_stencil(ops.T, chi, gridmetrics.topology))
    out = _kernel_apply(ops.T, chi, gridmetrics.topology)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)


def test_pallas_apply_f32(ops, gridmetrics, indices):
    """The card's hot path runs float32; the kernel must agree with the
    f32 jnp apply at f32 precision."""
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(1)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0).astype(np.float32)
    coeffs32 = _cast(ops.T, np.float32)

    ref = np.asarray(apply_stencil(coeffs32, chi, gridmetrics.topology))
    out = _kernel_apply(coeffs32, chi, gridmetrics.topology)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_pallas_euler_step(ops, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(2)
    chi = np.where(wet, 1.0 + 0.1 * rng.standard_normal(gridmetrics.shape), 0.0)
    dt = 100.0

    ref = chi - dt * np.asarray(apply_stencil(ops.T, chi, gridmetrics.topology))
    out = np.asarray(euler_step_pallas_multi(
        ops.T, chi[None], dt, gridmetrics.topology, "interpret")[0])
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nb", [3, 8])
def test_pallas_variants_match(ops, gridmetrics, indices, nb):
    """Batches of 3 and 8, f64: apply and fused Euler step."""
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(3)
    chis = np.where(wet[None], rng.standard_normal((nb,) + gridmetrics.shape),
                    0.0)
    ref = np.asarray(apply_stencil(ops.T, chis, topo))
    out = np.asarray(apply_stencil_pallas_multi(ops.T, chis, topo,
                                                "interpret"))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-13)
    out2 = np.asarray(euler_step_pallas_multi(ops.T, chis, 50.0, topo,
                                              "interpret"))
    np.testing.assert_allclose(out2, chis - 50.0 * ref, rtol=1e-12, atol=1e-11)


@pytest.mark.parametrize("nb", [1, 3])
def test_pallas_bf16_coefficients(ops, gridmetrics, indices, nb):
    """Mixed precision: bf16 coefficient fields, f32 chi/accumulation."""
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(4)
    chis = np.where(wet[None], rng.standard_normal((nb,) + gridmetrics.shape),
                    0.0).astype(np.float32)
    coeffs_bf16 = _cast(ops.T, jnp.bfloat16)

    ref = np.asarray(apply_stencil(ops.T, chis, topo))
    out = np.asarray(apply_stencil_pallas_multi(coeffs_bf16, chis, topo,
                                                "interpret"))
    assert out.dtype == np.float32
    # bf16 has ~3 significant decimal digits
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_xla_apply_matches_sparse_matrix(ops, gridmetrics, indices, dtype):
    """The plain path that replaced the single-tracer kernels: y = T chi
    against the assembled wet-cell matrix."""
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(5)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    mat = coeffs_to_scipy(ops.T, indices, topo)
    ref = mat @ chi[wet]
    out = np.asarray(apply_stencil(_cast(ops.T, dtype), chi.astype(dtype),
                                   topo))
    tol = 1e-12 if dtype == np.float64 else 2e-5
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out[wet] / scale, ref / scale, atol=tol)
    assert np.all(out[~wet] == 0)


@pytest.mark.parametrize("nsteps", [5, 7])
def test_explicit_propagate_matches_sparse_steps(ops, gridmetrics, indices,
                                                 nsteps):
    """explicit_euler_propagate (one compiled scan) against nsteps sparse
    matrix steps in f64."""
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(8)
    chi = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    dt = 120.0
    mat = coeffs_to_scipy(ops.T, indices, topo)
    ref = chi[wet]
    for _ in range(nsteps):
        ref = ref - dt * (mat @ ref)
    out = np.asarray(explicit_euler_propagate(ops.T, chi, dt, nsteps, topo))
    np.testing.assert_allclose(out[wet], ref, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("nb", [1, 3])
def test_propagate_kernel_loop_matches_xla(ops, gridmetrics, indices, nb):
    """A compiled loop of kernel steps equals XLA's propagation of the
    same batch (f64, so they agree to rounding)."""
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(9)
    chis = np.where(wet[None], rng.standard_normal((nb,) + gridmetrics.shape),
                    0.0)
    dt, nsteps = 120.0, 5
    out = jax.jit(lambda c: jax.lax.fori_loop(
        0, nsteps,
        lambda i, v: euler_step_pallas_multi(ops.T, v, dt, topo, "interpret"),
        c))(chis)
    ref = explicit_euler_propagate(ops.T, chis, dt, nsteps, topo)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-11, atol=1e-12)
