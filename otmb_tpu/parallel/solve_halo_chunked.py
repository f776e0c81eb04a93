"""Sharded host-chunked Krylov: fori_loop chunks inside shard_map.

The mesh analogue of `models/solvers.solve_shifted_chunked`:
host-controlled `lax.fori_loop` chunks with a scalar convergence fetch
between chunks, for large shards (see `solvers.CHUNKED_MIN_COLUMNS`):

  * each chunk is ONE jitted shard_map call running `chunk` BiCGStab
    (or BiCGStab(2)) iterations shard-locally: ppermute halo exchange +
    shard-local jnp stencil per operator application
    (parallel/halo.py), the shard-local Thomas preconditioner on the
    kernel route (k is never sharded), and one psum per dot product;
  * the Krylov state stays device-resident and SHARDED between chunks
    (chunk jits donate it); only the psum-replicated residual scalar is
    fetched to the host;
  * between chunks the host applies the same robustness machinery as
    the single-chip engine: best chunk-boundary iterate, in-pass
    divergence exit (recurrence > 4x pass start or NaN), cumulative
    3-chunk stall window, restart-from-best.

The scalar shift and extra diagonal are pre-baked into the stencil
diagonal (no post-kernel elementwise pass), exactly as in
solve_shifted_chunked.

Reference workload this serves: the implicit solves of
test/local_full.jl:165-188, at scale-out grid sizes on a device mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..grid.topology import GridTopology
from ..ops.coeffs import StencilCoeffs
from ..ops.pallas_util import kernel_route
from .halo import _halo_exchange, _local_stencil, _local_stencil_overlapped


def _pdot(a, b):
    return jax.lax.psum(jnp.vdot(a, b), ("y", "x"))


def _hc_make_ops(c_l, topology, mesh, preconditioner, route, overlap):
    from ..models.solvers import (
        _jacobi_preconditioner,
        _tridiag_preconditioner,
    )

    stencil = _local_stencil_overlapped if overlap else _local_stencil

    def a_op(x):
        return stencil(c_l, x, _halo_exchange(x, topology, mesh))

    if preconditioner == "tridiag":
        M = _tridiag_preconditioner(c_l, c_l.diag, route)
    elif preconditioner == "jacobi":
        M = _jacobi_preconditioner(c_l.diag)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    return M, a_op


def _hc_state_spec(algorithm: str):
    spec3 = P(None, "y", "x")
    spec0 = P()
    if algorithm == "bicgstab":
        return (spec3,) * 4 + (spec0,)
    return (spec3,) * 4 + (spec0,) * 3


# Module-level per-chunk programs: the jit cache persists across solves
# (nested closures would recompile the whole shard_map program per
# solve; see models/solvers._sr_chunk1).
@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8), donate_argnums=(1,))
def _hc_run_chunk(c_g, state_g, nsteps: int, topology: GridTopology,
                  mesh: Mesh, preconditioner: str, route: str,
                  overlap: bool, algorithm: str):
    spec3 = P(None, "y", "x")
    spec0 = P()
    cspec = jax.tree_util.tree_map(lambda _: spec3, c_g)
    state_spec = _hc_state_spec(algorithm)
    dtype = state_g[0].dtype

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(cspec, state_spec),
             out_specs=(state_spec, spec0), check_vma=False)
    def _run(c_l, st):
        M, a_op = _hc_make_ops(c_l, topology, mesh, preconditioner,
                               route, overlap)
        one = jnp.ones((), dtype)
        guard = lambda d: jnp.where(d == 0, one, d)

        if algorithm == "bicgstab":
            def body(_, s):
                x, r, p, rhat0, rho = s
                phat = M(p)
                v = a_op(phat)
                alpha = rho / guard(_pdot(rhat0, v))
                sv = r - alpha * v
                shat = M(sv)
                t = a_op(shat)
                tt = _pdot(t, t)
                omega = _pdot(t, sv) / guard(tt)
                x = x + alpha * phat + omega * shat
                r = sv - omega * t
                rho_new = _pdot(rhat0, r)
                beta = (rho_new / guard(rho)) * (alpha / guard(omega))
                p = r + beta * (p - omega * v)
                return (x, r, p, rhat0, rho_new)

            st = jax.lax.fori_loop(0, nsteps, body, st)
        else:
            def K(v):
                return a_op(M(v))

            def cycle(_, s):
                y, r0, u0, rhat, rho0, alpha, omega = s
                rho0 = -omega * rho0
                rho1 = _pdot(rhat, r0)
                beta = alpha * rho1 / guard(rho0)
                rho0 = rho1
                u0 = r0 - beta * u0
                u1 = K(u0)
                alpha = rho0 / guard(_pdot(rhat, u1))
                r0 = r0 - alpha * u1
                r1 = K(r0)
                y = y + alpha * u0
                rho1 = _pdot(rhat, r1)
                beta = alpha * rho1 / guard(rho0)
                rho0 = rho1
                u0 = r0 - beta * u0
                u1 = r1 - beta * u1
                u2 = K(u1)
                alpha = rho0 / guard(_pdot(rhat, u2))
                r0 = r0 - alpha * u1
                r1 = r1 - alpha * u2
                r2 = K(r1)
                y = y + alpha * u0
                t11 = _pdot(r1, r1)
                t12 = _pdot(r1, r2)
                t22 = _pdot(r2, r2)
                s1 = _pdot(r0, r1)
                s2 = _pdot(r0, r2)
                det = guard(t11 * t22 - t12 * t12)
                w1 = (t22 * s1 - t12 * s2) / det
                w2 = (t11 * s2 - t12 * s1) / det
                y = y + w1 * r0 + w2 * r1
                r0 = r0 - w1 * r1 - w2 * r2
                u0 = u0 - w1 * u1 - w2 * u2
                return (y, r0, u0, rhat, rho0, alpha, w2)

            st = jax.lax.fori_loop(0, nsteps, cycle, st)
        rnorm2 = _pdot(st[1], st[1]).real
        return st, rnorm2

    return _run(c_g, state_g)


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def _hc_restart(c_g, x_g, b_g, topology: GridTopology, mesh: Mesh,
                preconditioner: str, route: str, overlap: bool,
                algorithm: str):
    spec3 = P(None, "y", "x")
    cspec = jax.tree_util.tree_map(lambda _: spec3, c_g)
    state_spec = _hc_state_spec(algorithm)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(cspec, spec3, spec3),
             out_specs=(state_spec,), check_vma=False)
    def _restart(c_l, x_l, b_l):
        M, a_op = _hc_make_ops(c_l, topology, mesh, preconditioner,
                               route, overlap)
        if algorithm == "bicgstab":
            r = b_l - a_op(x_l)
            return ((x_l + 0.0, r, r + 0.0, r + 0.0, _pdot(r, r)),)
        r = b_l - a_op(M(x_l))
        zero = jnp.zeros((), b_l.dtype)
        return ((x_l + 0.0, r, jnp.zeros_like(r), r + 0.0,
                 jnp.ones((), b_l.dtype), zero,
                 jnp.ones((), b_l.dtype)),)

    return _restart(c_g, x_g, b_g)[0]


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def _hc_final_res(c_g, x_g, b_g, topology: GridTopology, mesh: Mesh,
                  preconditioner: str, route: str, overlap: bool,
                  algorithm: str):
    spec3 = P(None, "y", "x")
    spec0 = P()
    cspec = jax.tree_util.tree_map(lambda _: spec3, c_g)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(cspec, spec3, spec3),
             out_specs=(spec3, spec0), check_vma=False)
    def _fin(c_l, x_l, b_l):
        M, a_op = _hc_make_ops(c_l, topology, mesh, preconditioner,
                               route, overlap)
        if algorithm == "bicgstab2":
            x_l = M(x_l)  # bicgstab2 state lives in y-space
        r = a_op(x_l) - b_l
        bn2 = _pdot(b_l, b_l).real
        res = jnp.sqrt(_pdot(r, r).real
                       / jnp.where(bn2 == 0, 1.0, bn2))
        return x_l, res

    return _fin(c_g, x_g, b_g)


def solve_shifted_halo_chunked(
    coeffs: StencilCoeffs,
    b,
    topology: GridTopology,
    mesh: Mesh,
    shift=0.0,
    extra_diag=None,
    tol: float = 1e-10,
    maxiter: int = 2000,
    chunk: int = 50,
    transpose: bool = False,
    preconditioner: str = "tridiag",
    interpret: bool = False,
    overlap: bool = True,
    verbose: bool = False,
    early_stop: bool = True,
    max_restarts: int = 2,
    algorithm: str = "bicgstab",
    stats: dict | None = None,
):
    """Sharded `solve_shifted_chunked`: same contract — (x, relative
    residual recomputed from scratch), same `stats` fields, same
    robustness semantics — with every operator application running
    shard-locally on the mesh. NOT wrapped in jit (host control loop);
    the per-chunk work is jitted shard_map. The Thomas preconditioner
    runs on `kernel_route(interpret)`."""
    from ..models.solvers import _jacobi_preconditioner
    from ..ops.apply import transpose_coeffs

    route = kernel_route(interpret)
    b = jnp.asarray(b)
    shift = jnp.asarray(shift, b.dtype)
    extra = (0.0 if extra_diag is None
             else jnp.asarray(extra_diag, b.dtype))
    apply_coeffs = transpose_coeffs(coeffs, topology) if transpose else coeffs
    # Pre-bake shift + extra into the diagonal (transpose keeps the
    # diagonal, so this is valid for adjoint solves).
    shifted_diag = shift + extra + coeffs.diag
    a_coeffs = apply_coeffs._replace(diag=shifted_diag)

    spec3 = P(None, "y", "x")
    spec0 = P()
    cspec = jax.tree_util.tree_map(lambda _: spec3, a_coeffs)

    # Per-chunk programs are MODULE-LEVEL jits (_hc_run_chunk etc.):
    # shared jit cache across solves.
    statics = (topology, mesh, preconditioner, route, overlap, algorithm)
    if algorithm not in ("bicgstab", "bicgstab2"):
        raise ValueError(f"unknown algorithm {algorithm!r}")

    bnorm2 = float(jnp.vdot(b, b).real)
    atol2 = (tol ** 2) * bnorm2
    x0 = jnp.zeros_like(b)
    if algorithm == "bicgstab":
        state = (x0, b + 0.0, b + 0.0, b + 0.0, jnp.vdot(b, b))
    else:
        state = (x0, b + 0.0, jnp.zeros_like(b), b + 0.0,
                 jnp.ones((), b.dtype), jnp.zeros((), b.dtype),
                 jnp.ones((), b.dtype))

    iters = 0
    chunks_done = 0
    window_rn2 = float("inf")
    best_x = jnp.zeros_like(b)
    best_rn2 = bnorm2
    restarts = 0
    pass_rn2 = bnorm2
    rn2 = bnorm2
    stop = "maxiter"

    def do_restart():
        nonlocal state, restarts, window_rn2, pass_rn2
        restarts += 1
        state = None
        state = _hc_restart(a_coeffs, best_x, b, *statics)
        window_rn2 = float("inf")
        pass_rn2 = best_rn2

    while iters < maxiter:
        nsteps = min(chunk, maxiter - iters)
        if algorithm == "bicgstab":
            state, rnorm2 = _hc_run_chunk(a_coeffs, state, nsteps,
                                          *statics)
            iters += nsteps
        else:
            ncycles = max(1, nsteps // 2)
            state, rnorm2 = _hc_run_chunk(a_coeffs, state, ncycles,
                                          *statics)
            iters += 2 * ncycles
        rn2 = float(rnorm2)
        if rn2 < best_rn2:  # NaN-safe
            best_rn2 = rn2
            best_x = state[0] + 0.0
        if verbose:
            import sys as _sys

            print(f"#   halo-chunked iter {iters}: rel recurrence "
                  f"residual {(rn2 / bnorm2) ** 0.5:.3e}",
                  file=_sys.stderr)
        if rn2 <= atol2:
            stop = "converged"
            break
        if not rn2 <= 16.0 * pass_rn2:  # divergence exit, NaN-safe
            if restarts < max_restarts:
                do_restart()
                continue
            stop = "diverged"
            break
        chunks_done += 1
        if early_stop and chunks_done % 3 == 0:
            if rn2 >= (0.98 ** 2) * window_rn2:
                if restarts < max_restarts:
                    do_restart()
                    continue
                import warnings

                warnings.warn(
                    f"solve_shifted_halo_chunked: relative residual "
                    f"{(rn2 / bnorm2) ** 0.5:.3e} after {iters} "
                    f"iterations improved <2% over the last "
                    f"{3 * chunk} iterations (after {restarts} "
                    f"restart(s)); wrap in solve_shifted_ir or pass "
                    f"early_stop=False.",
                    stacklevel=2,
                )
                stop = "stall"
                break
            window_rn2 = rn2

    take_last = rn2 < best_rn2
    xsel = state[0] if take_last else best_x
    x, res = _hc_final_res(a_coeffs, xsel, b, *statics)
    if stats is not None:
        bn = bnorm2 ** 0.5 if bnorm2 > 0 else 1.0
        sel_rn2 = rn2 if take_last else best_rn2
        stats.update(
            iters=iters, restarts=restarts, stop=stop,
            start_rel=1.0, end_rel=(sel_rn2 ** 0.5) / bn,
        )
    return x, res
