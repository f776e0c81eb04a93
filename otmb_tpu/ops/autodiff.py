"""Differentiable operator layer: custom VJPs for the stencil apply and
Euler step, and the implicit-adjoint rule for steady-state solves.

The jnp paths (`ops.apply.apply_stencil`, `explicit_euler_propagate`) are
natively differentiable, and so is the fused assembly
(`assemble_transport` is jnp end to end, so kappa_h / kappa_vml /
kappa_vdeep / rho gradients come free). The exact rules below give the
apply and step cheaper adjoints than tracing through the gathers, and
JAX cannot differentiate the Krylov `while_loop` on its own:

  * apply:  y = T(c) x
        x_bar = T(c)' y_bar;   c_bar_d = y_bar * gather_d(x)
  * euler step:  y = x - dt T(c) x
        x_bar = y_bar - dt T' y_bar;   c_bar_d = -dt y_bar * gather_d(x)
  * implicit solve:  A(c) x = b,  A = sigma I + diag(D) + T(c)
        z = A'^{-1} x_bar
        b_bar = z;  sigma_bar = -<z, x>;  D_bar = -z * x;
        c_bar_d = -z * gather_d(x)          (implicit-function adjoint)

The adjoint solve reuses the SAME production solver (including the
sharded halo-exchange Krylov loop when `mesh` is set), so gradients run
at forward-solve speed. This composes with `jax.grad` through the whole
pipeline: mixing coefficients (kappa_h, kappa_GM, ...) can be calibrated
against observations by gradient descent — the reference ecosystem does
this offline with a hand-built transpose matrix (the sequestration-time
adjoint solve, test/local_full.jl:165-188); here it is one `jax.grad`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..grid.topology import DIRECTIONS, GridTopology, neighbor_values
from .apply import apply_stencil, apply_stencil_transpose
from .coeffs import StencilCoeffs


def _coeff_cotangents(ybar, x, topology: GridTopology, scale) -> StencilCoeffs:
    """d<ybar, T(c) x>/dc: each leg's cotangent is ybar times the gathered
    neighbor value it multiplies in the forward apply."""
    legs = {
        d: scale * ybar * neighbor_values(x, d, topology, fill=0.0)
        for d in DIRECTIONS
    }
    return StencilCoeffs(diag=scale * ybar * x, **legs)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def apply_stencil_ad(coeffs: StencilCoeffs, chi, topology: GridTopology):
    """y = T @ chi, differentiable in both the coefficients and the
    tracer through the exact rule above (the adjoint is one transpose
    apply)."""
    return apply_stencil(coeffs, chi, topology)


def _apply_ad_fwd(coeffs, chi, topology):
    return apply_stencil(coeffs, chi, topology), (coeffs, chi)


def _apply_ad_bwd(topology, res, ybar):
    coeffs, chi = res
    chi_bar = apply_stencil_transpose(coeffs, ybar, topology)
    one = jnp.asarray(1.0, ybar.dtype)
    return (_coeff_cotangents(ybar, chi, topology, one), chi_bar)


apply_stencil_ad.defvjp(_apply_ad_fwd, _apply_ad_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def euler_step_ad(coeffs: StencilCoeffs, chi, dt: float,
                  topology: GridTopology):
    """chi - dt * T @ chi (dt static), differentiable in coefficients and
    tracer — usable inside `lax.scan`/`fori_loop` propagation loops under
    `jax.grad`."""
    return chi - dt * apply_stencil(coeffs, chi, topology)


def _euler_ad_fwd(coeffs, chi, dt, topology):
    return euler_step_ad(coeffs, chi, dt, topology), (coeffs, chi)


def _euler_ad_bwd(dt, topology, res, ybar):
    coeffs, chi = res
    chi_bar = ybar - dt * apply_stencil_transpose(coeffs, ybar, topology)
    scale = jnp.asarray(-dt, ybar.dtype)
    return (_coeff_cotangents(ybar, chi, topology, scale), chi_bar)


euler_step_ad.defvjp(_euler_ad_fwd, _euler_ad_bwd)


def differentiable_solve(topology: GridTopology, **opts):
    """Build a differentiable steady-state solver
    `solve(coeffs, b, shift, extra_diag) -> x` with `(shift*I +
    diag(extra_diag) + T) x = b`, using the implicit-function adjoint:
    the backward pass is ONE transpose solve with the same production
    solver (`opts` are forwarded to `models.solvers.solve_shifted`, so
    `apply_impl="pallas"` / `mesh=...` give kernel-route or sharded
    halo-exchange adjoints).

    Unlike `solve_shifted` this returns only `x` (a residual diagnostic
    has no useful cotangent); the forward residual is still checked
    against `opts['tol']` semantics by the underlying solver contract.
    Reference workload made differentiable: the implicit solves of
    test/local_full.jl:165-188.
    """

    def _solve_impl(coeffs, b, shift, extra_diag):
        from ..models.solvers import solve_shifted

        x, _ = solve_shifted(
            coeffs, b, topology, shift=shift, extra_diag=extra_diag, **opts
        )
        return x

    solve = jax.custom_vjp(_solve_impl)

    def fwd(coeffs, b, shift, extra_diag):
        x = _solve_impl(coeffs, b, shift, extra_diag)
        return x, (coeffs, x, shift, extra_diag)

    def bwd(res, xbar):
        from ..models.solvers import solve_shifted

        coeffs, x, shift, extra_diag = res
        z, _ = solve_shifted(
            coeffs, xbar, topology, shift=shift, extra_diag=extra_diag,
            transpose=True, **opts
        )
        zx = z * x  # all fields are real
        shift_bar = (-jnp.sum(zx)).astype(jnp.asarray(shift).dtype)
        if extra_diag is None:
            extra_bar = None
        else:
            e = jnp.asarray(extra_diag)
            extra_bar = -zx if e.ndim else (-jnp.sum(zx)).astype(e.dtype)
        minus_one = jnp.asarray(-1.0, x.dtype)
        coeffs_bar = _coeff_cotangents(z, x, topology, minus_one)
        return (coeffs_bar, z, shift_bar, extra_bar)

    solve.defvjp(fwd, bwd)
    return solve
