"""Differentiable operator layer (ops/autodiff.py).

Oracles: the jnp apply path is natively differentiable, so JAX's own AD
is the exact reference for the custom apply/euler VJPs; the implicit
solve adjoint is checked against central finite differences and against
an end-to-end kappa_h calibration gradient (assembly is jnp end to end,
so kappa gradients compose through `assemble_transport`)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from otmb_tpu.grid.geometry import makegridmetrics
from otmb_tpu.grid.indices import makeindices
from otmb_tpu.models.transport import transportmatrix
from otmb_tpu.ops.apply import apply_stencil, transpose_coeffs
from otmb_tpu.ops.autodiff import (
    apply_stencil_ad,
    differentiable_solve,
    euler_step_ad,
)
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
from otmb_tpu.utils.synthetic import synthetic_dataset


@pytest.fixture(scope="module", params=["bipolar", "tripolar"])
def case(request):
    ds = synthetic_dataset(nx=12, ny=8, nz=5, topology=request.param, seed=9)
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
    rng = np.random.default_rng(3)
    chi = np.where(wet, rng.standard_normal(gm.shape), 0.0)
    w = np.where(wet, rng.standard_normal(gm.shape), 0.0)
    return ds, gm, idx, ops, gm.topology, chi, w


@pytest.mark.parametrize("transposed", [False, True])
def test_apply_grads_match_native_ad(case, transposed):
    """The custom rule on T and on the stencil form of T'."""
    _, _, _, ops, topo, chi, w = case
    coeffs = transpose_coeffs(ops.T, topo) if transposed else ops.T

    def loss_ad(c, x):
        return jnp.sum(w * apply_stencil_ad(c, x, topo) ** 2)

    def loss_native(c, x):
        return jnp.sum(w * apply_stencil(c, x, topo) ** 2)

    gc, gx = jax.grad(loss_ad, argnums=(0, 1))(coeffs, jnp.asarray(chi))
    rc, rx = jax.grad(loss_native, argnums=(0, 1))(coeffs, jnp.asarray(chi))
    np.testing.assert_allclose(np.asarray(gx), np.asarray(rx),
                               rtol=1e-12, atol=1e-18)
    for leg, a, b in zip(gc._fields, gc, rc):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-18,
            err_msg=f"coeff cotangent mismatch on leg {leg}",
        )


@pytest.mark.parametrize("transposed", [False, True])
def test_euler_scan_grads_match_native_ad(case, transposed):
    """Gradient through a 5-step propagation loop, on T and on T'."""
    _, _, _, ops, topo, chi, w = case
    coeffs = transpose_coeffs(ops.T, topo) if transposed else ops.T
    dt = 200.0

    def prop(step):
        def loss(c, x):
            def body(v, _):
                return step(c, v), None

            out, _ = jax.lax.scan(body, x, None, length=5)
            return jnp.sum(w * out ** 2)

        return loss

    loss_ad = prop(lambda c, v: euler_step_ad(c, v, dt, topo))
    loss_native = prop(lambda c, v: v - dt * apply_stencil(c, v, topo))
    gc, gx = jax.grad(loss_ad, argnums=(0, 1))(coeffs, jnp.asarray(chi))
    rc, rx = jax.grad(loss_native, argnums=(0, 1))(coeffs, jnp.asarray(chi))
    np.testing.assert_allclose(np.asarray(gx), np.asarray(rx),
                               rtol=1e-10, atol=1e-16)
    for leg, a, b in zip(gc._fields, gc, rc):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-16,
            err_msg=f"coeff cotangent mismatch on leg {leg}",
        )


def test_solve_adjoint_matches_finite_differences(case):
    _, _, idx, ops, topo, chi, w = case
    wet = np.asarray(idx.wet3d)
    b = np.where(wet, 1.0, 0.0)
    shift = 1e-5
    solve = differentiable_solve(topo, tol=1e-13)

    def loss(coeffs, b_, s_):
        return jnp.sum(w * solve(coeffs, b_, s_, None))

    g_coeffs, g_b, g_s = jax.grad(loss, argnums=(0, 1, 2))(
        ops.T, jnp.asarray(b), jnp.asarray(shift)
    )

    # finite differences on shift
    eps = 1e-9
    lp = float(loss(ops.T, b, shift + eps))
    lm = float(loss(ops.T, b, shift - eps))
    np.testing.assert_allclose(float(g_s), (lp - lm) / (2 * eps), rtol=2e-4)

    # finite differences on a few b entries
    ks, js, is_ = np.nonzero(wet)
    rng = np.random.default_rng(0)
    for t in rng.choice(len(ks), size=3, replace=False):
        c = (ks[t], js[t], is_[t])
        eps = 1e-6
        bp = b.copy(); bp[c] += eps
        bm = b.copy(); bm[c] -= eps
        fd = (float(loss(ops.T, bp, shift)) - float(loss(ops.T, bm, shift))) / (2 * eps)
        np.testing.assert_allclose(float(np.asarray(g_b)[c]), fd, rtol=5e-5,
                                   err_msg=f"b gradient at {c}")

    # finite differences on a few diag/east coefficient entries
    for leg in ("diag", "east"):
        arr = np.asarray(getattr(ops.T, leg))
        live = np.nonzero(np.abs(arr) > 1e-12)
        if len(live[0]) == 0:
            continue
        t = rng.choice(len(live[0]))
        c = tuple(d[t] for d in live)
        eps = max(1e-7 * abs(arr[c]), 1e-13)
        cp = ops.T._replace(**{leg: jnp.asarray(arr).at[c].add(eps)})
        cm = ops.T._replace(**{leg: jnp.asarray(arr).at[c].add(-eps)})
        fd = (float(loss(cp, b, shift)) - float(loss(cm, b, shift))) / (2 * eps)
        np.testing.assert_allclose(
            float(np.asarray(getattr(g_coeffs, leg))[c]), fd, rtol=1e-3,
            err_msg=f"coeff gradient on {leg} at {c}",
        )


def test_solve_adjoint_extra_diag_and_scalar(case):
    """extra_diag cotangents: per-cell field and scalar forms."""
    _, _, idx, ops, topo, chi, w = case
    wet = np.asarray(idx.wet3d)
    b = np.where(wet, 1.0, 0.0)
    surf = np.where(wet & (np.arange(wet.shape[0])[:, None, None] == 0),
                    1e-3, 0.0)
    solve = differentiable_solve(topo, tol=1e-13)

    def loss_field(e):
        return jnp.sum(w * solve(ops.T, jnp.asarray(b), 1e-5, e))

    g_e = jax.grad(loss_field)(jnp.asarray(surf))
    eps = 1e-9
    c = (0,) + tuple(np.argwhere(wet[0])[0])
    sp = surf.copy(); sp[c] += eps
    sm = surf.copy(); sm[c] -= eps
    fd = (float(loss_field(jnp.asarray(sp))) - float(loss_field(jnp.asarray(sm)))) / (2 * eps)
    np.testing.assert_allclose(float(np.asarray(g_e)[c]), fd, rtol=1e-3)

    def loss_scalar(e):
        return jnp.sum(w * solve(ops.T, jnp.asarray(b), 1e-5, e))

    g_s = jax.grad(loss_scalar)(jnp.asarray(1e-4))
    lp = float(loss_scalar(jnp.asarray(1e-4 + 1e-10)))
    lm = float(loss_scalar(jnp.asarray(1e-4 - 1e-10)))
    np.testing.assert_allclose(float(g_s), (lp - lm) / 2e-10, rtol=2e-4)


def test_kappa_calibration_gradient(case):
    """The flagship composition: d(loss)/d(kappa_h) through assembly AND
    the implicit steady-state solve, against finite differences — the
    gradient an oceanographer needs to calibrate mixing against
    observations."""
    ds, gm, idx, ops, topo, chi, w = case
    from otmb_tpu.models.transport import assemble_transport

    wet = idx.wet3d
    b = jnp.where(wet, 1.0, 0.0)
    umo = jnp.nan_to_num(jnp.asarray(ds.umo))
    vmo = jnp.nan_to_num(jnp.asarray(ds.vmo))
    solve = differentiable_solve(topo, tol=1e-13)

    def loss(kappa_h):
        T = assemble_transport(
            umo, vmo, ds.mlotst, gm, wet, kappa_h=kappa_h
        ).T
        x = solve(T, b, 1e-5, None)
        return jnp.sum(w * x)

    k0 = 500.0
    g = float(jax.grad(loss)(jnp.asarray(k0)))
    # Central difference with a wide step: the loss difference must rise
    # clearly above the 1e-13-relative solver residual noise; truncation
    # error is O(eps^2 / k0^2) relative and stays negligible.
    eps = 5.0
    fd = (float(loss(jnp.asarray(k0 + eps))) -
          float(loss(jnp.asarray(k0 - eps)))) / (2 * eps)
    assert abs(g - fd) <= 2e-3 * max(abs(fd), abs(g)), (g, fd)


def test_solve_adjoint_through_sharded_solver(case):
    """differentiable_solve composed with the sharded halo-Pallas Krylov
    loop (mesh=): forward and adjoint both run the shard_map solver; the
    gradients must match the single-device ones."""
    import jax as _jax

    if len(_jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device mesh")
    from otmb_tpu.parallel.mesh import make_grid_mesh, shard_pytree, sharding_for

    _, _, idx, ops, topo, chi, w = case
    mesh = make_grid_mesh(_jax.devices()[:8])
    wet = np.asarray(idx.wet3d)
    b = np.where(wet, 1.0, 0.0)

    solve_single = differentiable_solve(topo, tol=1e-13)
    solve_sharded = differentiable_solve(
        topo, tol=1e-13, apply_impl="pallas", mesh=mesh
    )

    def loss(solve, coeffs, b_):
        return jnp.sum(w * solve(coeffs, b_, 1e-5, None))

    g_ref = jax.grad(lambda c, b_: loss(solve_single, c, b_), argnums=(0, 1))(
        ops.T, jnp.asarray(b)
    )
    coeffs_sh = shard_pytree(mesh, ops.T)
    b_sh = jax.device_put(b, sharding_for(mesh, b))
    g_sh = jax.grad(lambda c, b_: loss(solve_sharded, c, b_), argnums=(0, 1))(
        coeffs_sh, b_sh
    )
    # every solve output (z = the b-gradient, and x inside the coefficient
    # cotangents) carries the age-scale conditioning (||A^-1|| ~ 1e9 s),
    # so two independently converged Krylov runs agree only to ~1e-3 of
    # each array's scale
    gb_ref = np.asarray(g_ref[1])
    gb_scale = max(float(np.abs(gb_ref).max()), 1e-30)
    np.testing.assert_allclose(
        np.asarray(g_sh[1]) / gb_scale, gb_ref / gb_scale,
        rtol=1e-3, atol=5e-4,
    )
    for leg, a, r in zip(g_sh[0]._fields, g_sh[0], g_ref[0]):
        ref_arr = np.asarray(r)
        scale = max(float(np.abs(ref_arr).max()), 1e-30)
        np.testing.assert_allclose(
            np.asarray(a) / scale, ref_arr / scale, rtol=1e-3, atol=5e-4,
            err_msg=f"sharded coeff gradient mismatch on {leg}",
        )
