"""Multichip Krylov: the WHOLE BiCGStab solve inside one shard_map region.

Without this module a Krylov solve on a mesh relies on GSPMD
auto-partitioning of the jnp matvec. Here the full solver loop runs
shard-locally:

  * matvec  — 1-cell ppermute halo exchange (periodic x, tripolar
    mirror-shard fold; parallel/halo.py) + the shard-local jnp stencil
    that XLA fuses, so every iteration's communication is four neighbor
    collective-permutes (NCCL on GPUs);
  * dot products / norms — local vdot + `lax.psum` over ('y', 'x')
    (one scalar all-reduce each, latency-bound, negligible);
  * preconditioner — the vertical-line (tridiagonal) solve is k-local
    and k is never sharded (the flux-closure scan constraint), so it
    applies shard-locally with zero communication; same for Jacobi;
  * the while_loop itself — every shard iterates in lockstep because
    the loop condition depends only on psum-replicated scalars.

Transpose solves (sequestration time) run the same forward loop on
`transpose_coeffs` (ops/apply.py), computed once outside the region
(GSPMD shifts preserve the sharding). Algorithm identical to
models/solvers._bicgstab_matrix_free; reference workload this serves:
the implicit solves of test/local_full.jl:165-188.
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
    """Global <a, b> on ('y', 'x')-sharded fields: local vdot + psum."""
    return jax.lax.psum(jnp.vdot(a, b), ("y", "x"))


@partial(
    jax.jit,
    static_argnames=("topology", "mesh", "maxiter", "transpose",
                     "preconditioner", "interpret", "overlap"),
)
def solve_shifted_halo(
    coeffs: StencilCoeffs,
    b,
    topology: GridTopology,
    mesh: Mesh,
    shift=0.0,
    extra_diag=None,
    tol: float = 1e-10,
    maxiter: int = 2000,
    transpose: bool = False,
    preconditioner: str = "tridiag",
    interpret: bool = False,
    overlap: bool = True,
):
    """Solve (shift*I + D_extra + T) x = b on a device mesh, matrix-free,
    with the halo-exchange matvec inside the Krylov loop (T' when
    `transpose`). The Thomas preconditioner runs shard-locally on
    `kernel_route(interpret)`. Same contract as
    models.solvers.solve_shifted: returns
    (x, relative_residual), residual recomputed from scratch; callers
    check it against their tolerance.

    `overlap=True` (default) removes the halo latency from the matvec's
    critical path: the bulk stencil runs on zero halos (no data
    dependency on the ppermutes, so XLA can schedule the
    collective-permutes concurrently with it), and the four shard-boundary
    rows/columns are patched when the permutes land — the same interior/
    boundary split as `euler_propagate_halo`. The result differs
    from the serialized matvec only by edge summation order (~1 ulp),
    which a Krylov iteration is insensitive to.
    """
    from ..models.solvers import (
        _jacobi_preconditioner,
        _tridiag_preconditioner,
    )
    from ..ops.apply import transpose_coeffs

    route = kernel_route(interpret)

    b = jnp.asarray(b)
    shift = jnp.asarray(shift, b.dtype)
    extra = (
        jnp.zeros((), b.dtype) if extra_diag is None
        else jnp.asarray(extra_diag, b.dtype)
    )

    # The forward stencil runs the adjoint problem on the stencil form of
    # T'; its top/bottom legs ARE the transposed vertical couplings, so
    # the tridiagonal preconditioner also builds from apply_coeffs
    # (matching models.solvers.solve_shifted's swapped-legs construction).
    apply_coeffs = transpose_coeffs(coeffs, topology) if transpose else coeffs

    spec3 = P(None, "y", "x")
    spec0 = P()
    extra_spec = spec0 if jnp.ndim(extra) == 0 else spec3

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            jax.tree_util.tree_map(lambda _: spec3, apply_coeffs),
            spec3, extra_spec, spec0,
        ),
        out_specs=(spec3, spec0),
        check_vma=False,  # pallas_call outputs carry no VMA metadata
    )
    def _solve(c_l, b_l, extra_l, shift_l):
        stencil = _local_stencil_overlapped if overlap else _local_stencil

        def a_op(x):
            halos = _halo_exchange(x, topology, mesh)
            return shift_l * x + extra_l * x + stencil(c_l, x, halos)

        shifted_diag = shift_l + extra_l + c_l.diag
        if preconditioner == "tridiag":
            # Shard-local Thomas solve: k is never sharded, so each
            # shard solves its own full columns.
            M = _tridiag_preconditioner(c_l, shifted_diag, route)
        elif preconditioner == "jacobi":
            M = _jacobi_preconditioner(shifted_diag)
        else:
            raise ValueError(f"unknown preconditioner {preconditioner!r}")

        bnorm2 = _pdot(b_l, b_l).real
        atol2 = (tol ** 2) * bnorm2

        x0 = jnp.zeros_like(b_l)
        r0 = b_l  # x0 == 0
        state0 = (x0, r0, r0, r0, _pdot(r0, r0), jnp.asarray(0))
        # state: (x, r, p, rhat0, rho, iters)

        def cond(state):
            _, r, *_, iters = state
            return (_pdot(r, r).real > atol2) & (iters < maxiter)

        def body(state):
            x, r, p, rhat0, rho, iters = state
            phat = M(p)
            v = a_op(phat)
            denom = _pdot(rhat0, v)
            alpha = rho / jnp.where(denom == 0, 1.0, denom)
            s = r - alpha * v
            shat = M(s)
            t = a_op(shat)
            tt = _pdot(t, t)
            omega = _pdot(t, s) / jnp.where(tt == 0, 1.0, tt)
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            rho_new = _pdot(rhat0, r)
            beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
                alpha / jnp.where(omega == 0, 1.0, omega)
            )
            p = r + beta * (p - omega * v)
            return (x, r, p, rhat0, rho_new, iters + 1)

        x, *_ = jax.lax.while_loop(cond, body, state0)

        rfin = a_op(x) - b_l
        bnorm_safe = jnp.where(bnorm2 == 0, 1.0, bnorm2)
        res = jnp.sqrt(_pdot(rfin, rfin).real / bnorm_safe)
        return x, res

    return _solve(apply_coeffs, b, extra, shift)
