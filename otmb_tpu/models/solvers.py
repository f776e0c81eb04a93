"""Time stepping and matrix-free linear solves for the transport operator.

The reference's downstream workloads (test/local_full.jl:111-188) use a
host sparse direct solve `(T_c + M_c) \\ s` (~3 min on a laptop). Here the
operator is never materialized: implicit steps and steady states are
solved with on-device Krylov methods (BiCGStab/GMRES — T is nonsymmetric)
under jit, with Jacobi preconditioning from the stencil diagonal.

All tracer fields are dense (nz, ny, nx) with exact zeros on land; every
operator application preserves that invariant, so the Krylov iterations
stay confined to the wet subspace.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.sparse.linalg import bicgstab, gmres

from ..grid.topology import GridTopology, neighbor_values
from ..ops.apply import apply_stencil, apply_stencil_transpose, transpose_coeffs
from ..ops.coeffs import StencilCoeffs
from ..ops.pallas_util import kernel_route
from ..ops.stencil_pallas import (
    apply_stencil_pallas_multi,
    euler_step_pallas_multi,
)
from ..ops.tridiag_pallas import tridiag_solve


@partial(jax.jit, static_argnames=("topology",))
def explicit_euler_step(coeffs: StencilCoeffs, chi, dt, topology: GridTopology):
    """chi - dt * T chi (forward Euler for d(chi)/dt = -T chi)."""
    return chi - dt * apply_stencil(coeffs, chi, topology)


@partial(jax.jit, static_argnames=("topology", "nsteps"))
def explicit_euler_propagate(
    coeffs: StencilCoeffs, chi, dt, nsteps: int, topology: GridTopology
):
    """nsteps of forward Euler as a single compiled scan. `chi` is one
    (nz, ny, nx) tracer — XLA's fused step — or a (B, nz, ny, nx) batch,
    which takes the batched stencil kernel on the GPU
    (`ops/stencil_pallas.py`; the same plain step on the CPU)."""

    if jnp.ndim(chi) == 4:
        route = kernel_route()

        def body(c, _):
            return euler_step_pallas_multi(coeffs, c, dt, topology,
                                           route), None
    else:
        def body(c, _):
            return c - dt * apply_stencil(coeffs, c, topology), None

    out, _ = jax.lax.scan(body, jnp.asarray(chi), None, length=nsteps)
    return out


def _jacobi_preconditioner(diag):
    """M^-1 ~ 1/diag, guarded on land where diag == 0."""
    safe = jnp.where(diag != 0, diag, 1.0)
    inv = jnp.where(diag != 0, 1.0 / safe, 0.0)
    return lambda x: inv * x


def _tridiag_preconditioner(coeffs: StencilCoeffs, shifted_diag,
                            route: str = "jnp"):
    """Vertical-line preconditioner: per-column tridiagonal solve of the
    operator's vertical part, M = diag(shifted) + T_top + T_bottom.

    The stiff entries of T are the mixed-layer vertical diffusion (kappa
    ratios of ~1e4 against the background), and they are exactly the
    tridiagonal k-coupling — so one Thomas sweep per column captures them.
    `route` (`ops.pallas_util.kernel_route`) picks the Thomas kernel or
    the plain scans; the solve applies to (nz, ny, nx) fields and to
    (B, nz, ny, nx) batches alike.
    """
    lower = coeffs.bottom  # couples to k+1
    upper = coeffs.top  # couples to k-1
    # Guard land columns (all-zero rows): unit diagonal.
    diag = jnp.where(shifted_diag != 0, shifted_diag,
                     jnp.ones((), jnp.result_type(shifted_diag)))
    return lambda b: tridiag_solve(lower, diag, upper, b, route)


def _swap_vertical(coeffs: StencilCoeffs, topology: GridTopology):
    """The vertical legs of T': T'[c, above(c)] = T[above(c), c] = the
    bottom leg of the cell above, and vice versa."""
    return coeffs._replace(
        top=neighbor_values(coeffs.bottom, "top", topology, fill=0.0),
        bottom=neighbor_values(coeffs.top, "bottom", topology, fill=0.0),
    )


def _bicgstab_matrix_free(a_op, b, M, tol, maxiter):
    """Right-preconditioned BiCGStab as a plain lax.while_loop.

    Same algorithm (and M semantics) as jax.scipy.sparse.linalg.bicgstab,
    but WITHOUT the custom_linear_solve wrapper — that wrapper traces the
    preconditioner for transposition, which is impossible for an opaque
    kernel call. Used for the apply_impl='pallas' path.
    """
    bnorm = jnp.linalg.norm(b)
    atol2 = (tol * bnorm) ** 2

    x0 = jnp.zeros_like(b)
    r0 = b  # x0 == 0
    state0 = (x0, r0, r0, r0, jnp.vdot(r0, r0), jnp.asarray(0))
    # state: (x, r, p, rhat0, rho, iters)

    def cond(state):
        _, r, *_, iters = state
        return (jnp.vdot(r, r).real > atol2) & (iters < maxiter)

    def body(state):
        x, r, p, rhat0, rho, iters = state
        phat = M(p)
        v = a_op(phat)
        denom = jnp.vdot(rhat0, v)
        alpha = rho / jnp.where(denom == 0, 1.0, denom)
        s = r - alpha * v
        shat = M(s)
        t = a_op(shat)
        tt = jnp.vdot(t, t)
        omega = jnp.vdot(t, s) / jnp.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = jnp.vdot(rhat0, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
            alpha / jnp.where(omega == 0, 1.0, omega)
        )
        p = r + beta * (p - omega * v)
        return (x, r, p, rhat0, rho_new, iters + 1)

    x, *_ = jax.lax.while_loop(cond, body, state0)
    return x


@partial(jax.jit, static_argnames=("topology", "method", "maxiter", "transpose",
                                   "preconditioner", "apply_impl", "mesh"))
def solve_shifted(
    coeffs: StencilCoeffs,
    b,
    topology: GridTopology,
    shift=0.0,
    extra_diag=None,
    tol: float = 1e-10,
    method: str = "bicgstab",
    maxiter: int = 2000,
    transpose: bool = False,
    preconditioner: str = "tridiag",
    apply_impl: str = "jnp",
    mesh=None,
):
    """Solve (shift * I + D_extra + T) x = b matrix-free (T' instead of T
    when `transpose`, for adjoint problems like sequestration time).

    `shift` is a scalar (e.g. 1/dt for implicit Euler); `extra_diag` an
    optional per-cell diagonal field (e.g. the surface restoring mask of
    the ideal-age problem). Returns (x, residual_norm).

    An inner solve that exits at `maxiter` without converging is NOT an
    error — the only signal is the returned relative residual, which is
    always recomputed from scratch (`||Ax - b|| / ||b||`). Callers must
    check it against their tolerance; `solve_shifted_ir` does so and
    warns on refinement stagnation.

    `apply_impl="pallas"` takes the kernel route: the Thomas
    preconditioner runs as the GPU kernel (`ops/tridiag_pallas.py`; the
    plain scans on the CPU) inside a plain `lax.while_loop` BiCGStab.
    With `mesh` set it runs the WHOLE BiCGStab loop inside one shard_map
    region with the ppermute-halo matvec (parallel/solve_halo.py);
    `apply_impl="jnp"` on a mesh relies on GSPMD auto-partitioning of the
    jnp matvec instead. The matvec itself is XLA's fusion of
    `apply_stencil` on every route.
    """
    b = jnp.asarray(b)
    if mesh is not None and apply_impl == "pallas":
        if method != "bicgstab":
            raise ValueError(
                "mesh + apply_impl='pallas' requires method='bicgstab'"
            )
        from ..parallel.solve_halo import solve_shifted_halo

        return solve_shifted_halo(
            coeffs, b, topology, mesh, shift=shift, extra_diag=extra_diag,
            tol=tol, maxiter=maxiter, transpose=transpose,
            preconditioner=preconditioner,
        )
    if apply_impl not in ("pallas", "jnp"):
        raise ValueError(f"unknown apply_impl {apply_impl!r}")
    if apply_impl == "pallas" and method != "bicgstab":
        raise ValueError("apply_impl='pallas' requires method='bicgstab'")
    # Cast to the RHS dtype: a wide extra_diag (e.g. f64 under x64)
    # must not silently promote the whole Krylov recurrence.
    extra = (0.0 if extra_diag is None
             else jnp.asarray(extra_diag, b.dtype))
    apply = apply_stencil_transpose if transpose else apply_stencil

    def a_op(x):
        return shift * x + extra * x + apply(coeffs, x, topology)

    shifted_diag = shift + extra + coeffs.diag
    route = kernel_route() if apply_impl == "pallas" else "jnp"
    if preconditioner == "tridiag":
        m_coeffs = _swap_vertical(coeffs, topology) if transpose else coeffs
        precond = _tridiag_preconditioner(m_coeffs, shifted_diag, route)
    elif preconditioner == "jacobi":
        precond = _jacobi_preconditioner(shifted_diag)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    if method == "bicgstab":
        if apply_impl == "pallas":
            # jax.scipy's bicgstab wraps the loop in custom_linear_solve,
            # which traces the preconditioner for transposition; an
            # opaque kernel call has no transpose. Same algorithm, plain
            # while_loop.
            x = _bicgstab_matrix_free(a_op, b, precond, tol, maxiter)
        else:
            x, _ = bicgstab(a_op, b, tol=tol, atol=0.0, M=precond,
                            maxiter=maxiter)
    elif method == "gmres":
        x, _ = gmres(
            a_op, b, tol=tol, atol=0.0, M=precond, maxiter=maxiter,
            restart=30, solve_method="batched",
        )
    else:
        raise ValueError(f"unknown method {method!r}")

    res = jnp.linalg.norm(a_op(x) - b) / jnp.linalg.norm(b)
    return x, res


def implicit_euler_step(
    coeffs: StencilCoeffs,
    chi,
    dt,
    topology: GridTopology,
    tol: float = 1e-10,
    method: str = "bicgstab",
    apply_impl: str = "jnp",
):
    """One implicit Euler step: solve (I + dt T) chi_next = chi.

    Unconditionally stable — the matrix-free replacement for the
    reference's implicit solves with the assembled sparse matrix.
    """
    chi = jnp.asarray(chi)
    x, res = solve_shifted(
        coeffs, chi / dt, topology, shift=1.0 / dt, tol=tol, method=method,
        apply_impl=apply_impl,
    )
    return x, res


@partial(jax.jit, static_argnames=("topology", "transpose"))
def _ir_defect(c_narrow, x, b_narrow, extra_narrow, shift, bnorm_safe,
               topology: GridTopology, transpose: bool):
    """One wide-precision defect evaluation: r = b - A x, its norm s,
    the normalized narrow-precision defect, and the relative residual.

    Takes the NARROW coefficient fields, right-hand side, and extra
    diagonal, and promotes them to the wide dtype inside the jit (the
    narrow->wide conversion is exact, so the f64 defect is identical to
    one computed from persistent f64 copies): XLA fuses the converts
    into the stencil arithmetic, so no persistent wide copy of the 9
    coefficient streams, b, or extra_diag ever exists in HBM — at the
    0.25-degree scale-out size that is 8.4 GB of f64 coefficients plus
    1.9 GB of f64 b/extra avoided; the in-bench solve OOMed with the
    persistent copies and fits without them."""
    from ..ops.apply import apply_stencil_transpose

    wide = x.dtype
    c_wide = jax.tree_util.tree_map(lambda a: a.astype(wide), c_narrow)
    apply_wide = apply_stencil_transpose if transpose else apply_stencil
    r = jnp.asarray(b_narrow, wide) - (
        shift * x + jnp.asarray(extra_narrow, wide) * x
        + apply_wide(c_wide, x, topology))
    s = jnp.linalg.norm(r)
    s_safe = jnp.where(s == 0, 1.0, s)
    return r / s_safe, s_safe, s / bnorm_safe


@partial(jax.jit, donate_argnums=(0,))
def _ir_update(x, s_safe, d):
    return x + s_safe * d.astype(x.dtype)


def solve_shifted_ir(
    coeffs: StencilCoeffs,
    b,
    topology: GridTopology,
    shift=0.0,
    extra_diag=None,
    tol: float = 1e-9,
    inner_tol: float = 1e-4,
    max_refinements: int = 10,
    method: str = "bicgstab",
    maxiter: int = 2000,
    inner_maxiter: int | None = None,
    inner_algorithm: str = "bicgstab2",
    transpose: bool = False,
    preconditioner: str = "tridiag",
    apply_impl: str = "jnp",
    mesh=None,
    stats: dict | None = None,
):
    """`solve_shifted` with mixed-precision iterative refinement.

    `stats`, if given a dict, is filled with per-pass diagnostics:
    ``passes`` = list of one dict per refinement pass with ``rel_start``
    (the f64 defect relative residual entering the pass), ``reverted``
    (pass started from the recovery point), and — on the chunked inner
    path — the inner solve's own stats (``inner_iters``,
    ``inner_stop``, ``inner_restarts``, ``inner_end_rel``); plus
    ``refinements`` and ``rel_final``. This is how a slow solve's time
    is attributed from a bench artifact alone.

    Single-precision Krylov on this operator stagnates at relative
    residuals around 1e-3..1e-4 (age fields reach ~1e9 s while |T| rows
    are ~1e-3 1/s, so f32 matvec roundoff floors the recurrence). The
    classic fix: keep the Krylov inner solve in f32 and wrap it in a
    defect-correction loop whose residual r = b - A x is evaluated in
    f64 — only two f64 matvecs per refinement are needed. Each
    refinement contracts the error by roughly the inner solve's relative
    accuracy, so a handful of refinements reach f64-level residuals at
    f32 cost. (Whether plain f64 Krylov is as fast on a card with native
    f64 is an open question: ROADMAP S4.)

    Requires `jax.config jax_enable_x64` for true f64 residuals; without
    it the loop degrades to restarted f32 refinement (still tighter than
    a single solve) and a warning is issued. Returns (x_wide, rel_residual).

    bf16-narrow mode: pass COEFFICIENTS cast to bfloat16 (e.g. via
    `jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), coeffs)`)
    and the inner solves stream 7 bf16 coefficient planes instead of f32
    — nearly halving the dominant matvec traffic — while the Krylov
    vectors stay f32 and the f64 defect correction still converges to
    `tol` AGAINST THE bf16-ROUNDED OPERATOR (which differs from the f32
    one by ~0.4% coefficient rounding; choose the width to match the
    accuracy the application needs).

    The refinement loop runs on the host (one compiled defect step + one
    compiled inner solve per refinement, a scalar fetch in between): a
    fully fused nested-while formulation overflows CPython's C-stack
    guard when tracing inside two while_loop levels, and a handful of
    extra dispatches is negligible against solve time.
    """
    if not jax.config.jax_enable_x64:
        import warnings

        warnings.warn(
            "solve_shifted_ir without jax_enable_x64: residuals are "
            "evaluated in f32, refinement cannot beat the f32 floor",
            stacklevel=2,
        )
    wide = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    narrow = coeffs.diag.dtype
    # bf16-narrow mode: bf16 COEFFICIENT streams halve the dominant
    # matvec traffic of the inner solves, but the Krylov recurrence
    # vectors themselves must stay f32 — a bf16 recurrence floors near
    # 1e-2 and refinement would stagnate. So the inner right-hand side
    # (and hence the whole Krylov state) is kept at >= f32 while the
    # operator coefficients stream at whatever width they were given.
    narrow_vec = jnp.float32 if narrow == jnp.bfloat16 else narrow

    # b and extra_diag stay NARROW here and are promoted inside
    # _ir_defect (exactly — see its docstring); only the accumulating
    # iterate x is persistently wide.
    b_n = jnp.asarray(b)
    extra_n = (jnp.zeros((), b_n.dtype) if extra_diag is None
               else jnp.asarray(extra_diag))
    shift_wide = jnp.asarray(shift, wide)

    # ||b|| in narrow precision (never below f32), promoted as a SCALAR:
    # bnorm only ever normalizes reported residuals — a ~1e-7 relative
    # rounding in the denominator shifts every rel by the same factor,
    # which affects no convergence decision (tol comparisons are against
    # the same normalization throughout).
    bnorm = jnp.linalg.norm(b_n.astype(narrow_vec)).astype(wide)
    bnorm_safe = jnp.where(bnorm == 0, 1.0, bnorm)

    # On large grids the inner f32 solves go through the host-chunked
    # BiCGStab(2) engine (see `_use_chunked`). It is BiCGStab-only:
    # honor an explicit method='gmres' request with the while_loop path
    # instead of silently switching algorithms.
    chunked_inner = (method == "bicgstab"
                     and _use_chunked(apply_impl, mesh, False, topology))
    # Mesh analogue: large shards take the sharded chunked engine.
    halo_chunked_inner = (method == "bicgstab"
                          and _use_halo_chunked(apply_impl, mesh, False,
                                                topology))
    if method != "bicgstab" and _use_chunked(apply_impl, mesh, False,
                                             topology):
        import warnings

        warnings.warn(
            f"solve_shifted_ir: method={method!r} prevents the chunked "
            "BiCGStab(2) engine at this grid size; the inner solves use "
            "the while_loop solver",
            stacklevel=2,
        )
    # Per-pass inner iteration budget. On large grids the later defect
    # systems routinely stagnate: their useful contraction happens in
    # the first few hundred iterations, so an uncapped budget turns each
    # stagnating pass into a long run of wasted chunks. 600 held the
    # useful-work envelope at 0.25 degree; small grids converge long
    # before any cap matters.
    if inner_maxiter is None:
        inner_maxiter = (min(maxiter, 600)
                         if (chunked_inner or halo_chunked_inner)
                         else maxiter)
    else:
        inner_maxiter = min(maxiter, inner_maxiter)

    x = jnp.zeros(b_n.shape, wide)
    rel = jnp.asarray(jnp.inf, wide)
    rel_prev = float("inf")
    stagnant = 0
    r_hat = d = None
    # Outer best-iterate tracking: an inner Krylov pass that diverges
    # (BiCGStab breakdown) would otherwise hand _ir_update a garbage
    # correction and destroy x for every later pass — observed once at
    # 0.25 degree (relative residual blew up to ~1e3). Keep the best
    # iterate seen at a defect evaluation; revert to it when a pass made
    # things much worse; return it if the final iterate is not the best.
    # Stored NARROW (f32): it is a recovery point, not the result — in
    # the convergent path the final full-precision x is the best and is
    # returned untouched; storing wide would cost another 0.9 GB at the
    # 0.25-degree size (measured OOM). If the recovery point IS
    # returned, its residual is honestly recomputed first.
    best_x = None
    best_rel = float("inf")
    pass_log = [] if stats is None else stats.setdefault("passes", [])
    import time as _time

    for _pass_i in range(max_refinements):
        _t_pass = _time.perf_counter()
        # Drop the previous pass's defect and correction BEFORE the next
        # wide defect evaluation: at the 0.25-degree scale keeping them
        # live (1.4 GB) across the f64 apply tips the device into OOM.
        r_hat = d = None
        if _pass_i == 0:
            # x == 0 exactly, so the defect IS b: skip the wide apply
            # and normalize in b's own (narrow) dtype. Consistency is
            # what matters for correctness: s_safe and the rhs
            # normalization use the SAME value, so norm rounding cancels
            # in the update x += s_safe * d; it only shifts the reported
            # rel by O(norm rounding), multiplicatively.
            b_nv = b_n.astype(narrow_vec)  # never below f32
            bn_n = jnp.linalg.norm(b_nv)
            bn_n_safe = jnp.where(bn_n == 0, 1.0, bn_n)
            r_hat = b_nv / bn_n_safe
            s_safe = bn_n_safe.astype(wide)
            rel = (bn_n / bn_n_safe).astype(wide)  # 1.0; 0.0 if b == 0
        else:
            r_hat, s_safe, rel = _ir_defect(
                coeffs, x, b_n, extra_n, shift_wide, bnorm_safe,
                topology, transpose,
            )
        relf = float(rel)
        if relf < best_rel:
            best_rel = relf
            # astype copies (x is donated by _ir_update below); the +0.0
            # covers the dtype-equal case where astype is a no-op view
            best_x = (x.astype(narrow_vec) if x.dtype != narrow_vec
                      else x + 0.0)
        if relf <= tol:
            if stats is not None:
                # the converging defect eval creates no pass entry;
                # record its wall separately so artifacts add up
                stats["final_defect_s"] = _time.perf_counter() - _t_pass
            break
        if best_x is not None and relf > 4.0 * best_rel:
            # the last pass diverged; refine from the best iterate, not
            # from the damaged one (f32-rounded recovery point: the
            # remaining defect corrections rebuild full precision).
            # COPY when dtypes already match: astype would be a no-op
            # view of best_x, and _ir_update donates x — a donated alias
            # would delete the recovery point out from under any later
            # revert or the final candidate check (advisor round 4;
            # invisible on CPU where donation is a no-op).
            r_hat = None  # free the bad defect before re-evaluating
            x = (best_x.astype(wide) if best_x.dtype != wide
                 else best_x + 0.0)
            r_hat, s_safe, rel = _ir_defect(
                coeffs, x, b_n, extra_n, shift_wide, bnorm_safe,
                topology, transpose,
            )
            relf = float(rel)
            reverted = True
        else:
            reverted = False
        pass_entry = {"rel_start": relf, "reverted": reverted,
                      "defect_s": _time.perf_counter() - _t_pass}
        pass_log.append(pass_entry)
        # Each refinement should contract the residual by roughly
        # inner_tol; no contraction means the inner Krylov solve is
        # stagnating (likely exiting at maxiter far from inner_tol).
        # One slow pass can be a transient (e.g. a BiCGStab breakdown
        # restart), so only break after TWO consecutive non-contracting
        # passes — then burning the remaining refinements cannot help;
        # stop and tell the caller why the returned residual misses tol.
        stagnant = stagnant + 1 if relf >= 0.9 * rel_prev else 0
        if stagnant >= 2:
            import warnings

            warnings.warn(
                f"solve_shifted_ir: refinement stagnated at relative "
                f"residual {relf:.3e} (previous {rel_prev:.3e}); "
                f"the inner {method} solve is likely exiting at its "
                f"inner_maxiter={inner_maxiter} budget without reaching "
                f"inner_tol={inner_tol}. Raise the inner_maxiter "
                f"parameter (the outer maxiter={maxiter} does not bound "
                f"the inner passes) or loosen tol.",
                stacklevel=2,
            )
            pass_entry["stagnated"] = True
            break
        rel_prev = relf
        # Dynamic per-pass tolerance: a late pass only needs to contract
        # the defect by the REMAINING gap to tol, not all the way to
        # inner_tol. With the outer defect at relf, an inner contraction
        # of 0.5*tol/relf already lands the next defect at tol/2 — e.g.
        # at 0.25 degree the final pass needed a 3x contraction but
        # burned its full 600-iteration budget chasing inner_tol=1e-4
        # (run log: pass 3 "600 iters -> stall" where ~100 sufficed).
        # The 0.5 safety factor absorbs the recurrence-vs-true residual
        # mismatch at pass exit.
        pass_tol = min(0.9, max(inner_tol, 0.5 * tol / relf))
        pass_entry["inner_tol"] = pass_tol
        rhs = r_hat.astype(narrow_vec)
        r_hat = None  # the wide defect (0.9 GB at 0.25-degree) is spent
        if chunked_inner:
            # max_restarts=0: each refinement pass already starts a
            # fresh Krylov space on the f64-corrected defect — the outer
            # loop IS the restart mechanism, and inner restarts just
            # push stalled passes to the full budget. The stall-exit
            # (3-chunk window) caps a stagnating pass at ~150 wasted
            # iterations instead. inner_algorithm defaults to
            # bicgstab2: the defect systems stall BiCGStab(1) via omega
            # breakdowns on the advective spectrum, while BiCGStab(l=2)'s
            # 2D minimal-residual polish converges them (at 0.25 degree
            # it reached 1.1e-6 where BiCGStab(1) runs ended near 7e-6).
            inner_stats = {}
            d, _ = solve_shifted_chunked(
                coeffs, rhs, topology, shift=shift,
                extra_diag=extra_diag, tol=pass_tol,
                maxiter=inner_maxiter, transpose=transpose,
                preconditioner=preconditioner, max_restarts=0,
                algorithm=inner_algorithm, stats=inner_stats,
            )
            pass_entry.update(
                inner_iters=inner_stats.get("iters"),
                inner_stop=inner_stats.get("stop"),
                inner_restarts=inner_stats.get("restarts"),
                inner_end_rel=inner_stats.get("end_rel"),
                inner_chunk_s=inner_stats.get("chunk_s"),
            )
        elif halo_chunked_inner:
            from ..parallel.solve_halo_chunked import (
                solve_shifted_halo_chunked,
            )

            inner_stats = {}
            d, _ = solve_shifted_halo_chunked(
                coeffs, rhs, topology, mesh, shift=shift,
                extra_diag=extra_diag, tol=pass_tol,
                maxiter=inner_maxiter, transpose=transpose,
                preconditioner=preconditioner, max_restarts=0,
                algorithm=inner_algorithm, stats=inner_stats,
            )
            pass_entry.update(
                inner_iters=inner_stats.get("iters"),
                inner_stop=inner_stats.get("stop"),
                inner_restarts=inner_stats.get("restarts"),
                inner_end_rel=inner_stats.get("end_rel"),
                inner_chunk_s=inner_stats.get("chunk_s"),
            )
        else:
            d, _ = solve_shifted(
                coeffs, rhs, topology, shift=shift,
                extra_diag=extra_diag, tol=pass_tol, method=method,
                maxiter=inner_maxiter, transpose=transpose,
                preconditioner=preconditioner, apply_impl=apply_impl,
                mesh=mesh,
            )
        rhs = None
        x = _ir_update(x, s_safe, d)
        # Wall time of this pass (defect eval + inner solve; the update
        # dispatch is async — its tail lands in the NEXT pass's
        # defect_s, so the per-pass sum is exact even if the split is
        # approximate at the boundary).
        pass_entry["wall_s"] = _time.perf_counter() - _t_pass
    else:
        _, _, rel = _ir_defect(
            coeffs, x, b_n, extra_n, shift_wide, bnorm_safe,
            topology, transpose,
        )
        relf = float(rel)
        if relf < best_rel:
            best_rel, best_x = relf, x
    if best_x is not None and best_rel < float(rel):
        # Candidate: the f32-rounded recovery point. Recompute its
        # residual honestly (rounding may have degraded it) and keep
        # whichever iterate is actually better.
        x_cand = best_x.astype(wide)
        _, _, rel_cand = _ir_defect(
            coeffs, x_cand, b_n, extra_n, shift_wide, bnorm_safe,
            topology, transpose,
        )
        if float(rel_cand) < float(rel):
            x, rel = x_cand, rel_cand
    if stats is not None:
        # Sync the result so everything this solve dispatched is
        # attributed HERE rather than at the caller's first use — the
        # ~1 extra ms of eagerness buys artifacts whose pass/tail
        # times add up to the caller's wall clock.
        _t_tail = _time.perf_counter()
        x = jax.block_until_ready(x)
        stats.update(refinements=len(pass_log), rel_final=float(rel),
                     tail_s=_time.perf_counter() - _t_tail)
    return x, rel


#: Horizontal cells (ny * nx) of one device's grid from which the
#: steady-state entry points take the host-chunked BiCGStab(2) engines.
#: On the 0.25-degree grid (1440 x 1080) the raw f32 age system breaks
#: BiCGStab(1)'s recurrence down to NaN (omega breakdowns on the
#: advective spectrum) while BiCGStab(2)'s cycles converge it; the
#: 1-degree grid (360 x 300) and a 0.25-degree shard of a 2 x 2 mesh
#: (720 x 540) converge with the while_loop BiCGStab.
CHUNKED_MIN_COLUMNS = 2**19


def _use_chunked(apply_impl, mesh, refine, topology) -> bool:
    """True when a non-refined single-device steady-state solve takes
    the host-chunked BiCGStab(2) engine (see `CHUNKED_MIN_COLUMNS`)."""
    return (apply_impl == "pallas" and mesh is None and not refine
            and topology.ny * topology.nx >= CHUNKED_MIN_COLUMNS)


def _use_halo_chunked(apply_impl, mesh, refine, topology) -> bool:
    """Mesh analogue of `_use_chunked`, on the per-shard grid."""
    if apply_impl != "pallas" or mesh is None or refine:
        return False
    shard_cols = (max(1, topology.ny // mesh.shape.get("y", 1))
                  * max(1, topology.nx // mesh.shape.get("x", 1)))
    return shard_cols >= CHUNKED_MIN_COLUMNS


def ideal_age(
    coeffs: StencilCoeffs,
    wet3d,
    topology: GridTopology,
    surface_rate: float = 1.0,
    tol: float = 1e-8,
    method: str = "bicgstab",
    apply_impl: str = "jnp",
    refine: bool = False,
    mesh=None,
    stats: dict | None = None,
):
    """Steady-state ideal mean age Gamma (seconds), governed by
    T Gamma = 1 - M Gamma with M a fast surface restoring mask
    (reference test/local_full.jl:155-168):

        (T + M) Gamma = 1  on wet cells,  M = surface_rate * 1_surface.

    Returns (gamma3d_seconds, residual_norm). Divide by 365.25*24*3600
    for years. `refine=True` wraps the solve in mixed-precision
    iterative refinement (see `solve_shifted_ir`) — use it for f32
    operators, where Krylov alone floors around 1e-4 relative residual.
    """
    wet = jnp.asarray(wet3d, bool)
    dtype = coeffs.diag.dtype
    ones = jnp.where(wet, jnp.ones(wet.shape, dtype), 0.0)
    surf = jnp.zeros(wet.shape, dtype).at[0].set(surface_rate)
    surf = jnp.where(wet, surf, 0.0)
    if _use_chunked(apply_impl, mesh, refine, topology):
        # BiCGStab(2): the raw f32 age system NaNs BiCGStab(1)'s
        # recurrence on stiff grids (see CHUNKED_MIN_COLUMNS).
        gamma, res = solve_shifted_chunked(
            coeffs, ones, topology, shift=0.0, extra_diag=surf, tol=tol,
            algorithm="bicgstab2", stats=stats,
        )
        return jnp.where(wet, gamma, jnp.nan), res
    if _use_halo_chunked(apply_impl, mesh, refine, topology):
        from ..parallel.solve_halo_chunked import solve_shifted_halo_chunked

        gamma, res = solve_shifted_halo_chunked(
            coeffs, ones, topology, mesh, shift=0.0, extra_diag=surf,
            tol=tol, algorithm="bicgstab2", stats=stats,
        )
        return jnp.where(wet, gamma, jnp.nan), res
    if refine:
        gamma, res = solve_shifted_ir(
            coeffs, ones, topology, shift=0.0, extra_diag=surf, tol=tol,
            method=method, apply_impl=apply_impl, mesh=mesh, stats=stats,
        )
    else:
        gamma, res = solve_shifted(
            coeffs, ones, topology, shift=0.0, extra_diag=surf, tol=tol,
            method=method, apply_impl=apply_impl, mesh=mesh,
        )
    return jnp.where(wet, gamma, jnp.nan), res


def sequestration_time(
    coeffs: StencilCoeffs,
    wet3d,
    topology: GridTopology,
    surface_rate: float = 1.0,
    tol: float = 1e-8,
    method: str = "bicgstab",
    apply_impl: str = "jnp",
    refine: bool = False,
    mesh=None,
    stats: dict | None = None,
):
    """Mean sequestration time (seconds): the adjoint of ideal age —
    expected time for water at each cell to next contact the surface,
    governed by the transpose operator:

        (T' + M) Gamma_dagger = 1  on wet cells.

    Uses the exact transpose of the stencil apply (ops/apply.py), so
    adjoint consistency with the forward operator is structural.
    """
    wet = jnp.asarray(wet3d, bool)
    dtype = coeffs.diag.dtype
    ones = jnp.where(wet, jnp.ones(wet.shape, dtype), 0.0)
    surf = jnp.zeros(wet.shape, dtype).at[0].set(surface_rate)
    surf = jnp.where(wet, surf, 0.0)
    if _use_chunked(apply_impl, mesh, refine, topology):
        gamma, res = solve_shifted_chunked(
            coeffs, ones, topology, shift=0.0, extra_diag=surf, tol=tol,
            transpose=True, algorithm="bicgstab2", stats=stats,
        )
        return jnp.where(wet, gamma, jnp.nan), res
    if _use_halo_chunked(apply_impl, mesh, refine, topology):
        from ..parallel.solve_halo_chunked import solve_shifted_halo_chunked

        gamma, res = solve_shifted_halo_chunked(
            coeffs, ones, topology, mesh, shift=0.0, extra_diag=surf,
            tol=tol, transpose=True, algorithm="bicgstab2", stats=stats,
        )
        return jnp.where(wet, gamma, jnp.nan), res
    if refine:
        gamma, res = solve_shifted_ir(
            coeffs, ones, topology, shift=0.0, extra_diag=surf, tol=tol,
            method=method, transpose=True, apply_impl=apply_impl,
            mesh=mesh, stats=stats,
        )
    else:
        gamma, res = solve_shifted(
            coeffs, ones, topology, shift=0.0, extra_diag=surf, tol=tol,
            method=method, transpose=True, apply_impl=apply_impl,
            mesh=mesh,
        )
    return jnp.where(wet, gamma, jnp.nan), res


def _bicgstab_matrix_free_multi(a_op, bs, M, tol, maxiter):
    """B independent right-preconditioned BiCGStab solves in lockstep.

    Each batch member carries its own Krylov scalars; the matvec is the
    BATCHED operator application (the whole point: coefficient streams
    shared across the batch, ops/stencil_pallas.py). The loop
    runs until every member meets its own tolerance; converged members
    idle harmlessly (their alpha/omega collapse to ~0 through the
    zero-division guards) and the final residuals are recomputed from
    scratch by the caller."""
    axes = tuple(range(1, bs.ndim))
    dot = lambda u, v: jnp.sum(u * v, axis=axes)  # (B,); fields are real
    bx = lambda s: s.reshape(s.shape + (1,) * (bs.ndim - 1))

    atol2 = (tol ** 2) * dot(bs, bs)

    x0 = jnp.zeros_like(bs)
    state0 = (x0, bs, bs, bs, dot(bs, bs), jnp.asarray(0))
    # state: (x, r, p, rhat0, rho, iters)

    def cond(state):
        _, r, *_, iters = state
        return jnp.any(dot(r, r) > atol2) & (iters < maxiter)

    def body(state):
        x, r, p, rhat0, rho, iters = state
        phat = M(p)
        v = a_op(phat)
        denom = dot(rhat0, v)
        alpha = rho / jnp.where(denom == 0, 1.0, denom)
        s = r - bx(alpha) * v
        shat = M(s)
        t = a_op(shat)
        tt = dot(t, t)
        omega = dot(t, s) / jnp.where(tt == 0, 1.0, tt)
        x = x + bx(alpha) * phat + bx(omega) * shat
        r = s - bx(omega) * t
        rho_new = dot(rhat0, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
            alpha / jnp.where(omega == 0, 1.0, omega)
        )
        p = r + bx(beta) * (p - bx(omega) * v)
        return (x, r, p, rhat0, rho_new, iters + 1)

    x, *_ = jax.lax.while_loop(cond, body, state0)
    return x


@partial(jax.jit, static_argnames=("topology", "maxiter", "transpose",
                                   "preconditioner", "apply_impl",
                                   "interpret"))
def solve_shifted_multi(
    coeffs: StencilCoeffs,
    bs,
    topology: GridTopology,
    shift=0.0,
    extra_diag=None,
    tol: float = 1e-10,
    maxiter: int = 2000,
    transpose: bool = False,
    preconditioner: str = "tridiag",
    apply_impl: str = "pallas",
    interpret: bool = False,
):
    """Solve (shift*I + D_extra + T) x_b = b_b for a BATCH of right-hand
    sides (bs is (B, nz, ny, nx)) in one lockstep BiCGStab.

    All B solves share the same operator, so with `apply_impl="pallas"`
    the matvec runs through the batched stencil kernel (coefficients
    read once per tile and shared across the batch — per-solve matvec
    traffic 2 + 7/B streams instead of 9) and the Thomas preconditioner
    through its kernel, both on the route `kernel_route(interpret)`
    gives. This is the natural engine for families of steady states
    against one circulation: water-mass-fraction tracers, dye releases
    from multiple regions, ensembles of boundary conditions. Returns
    (xs, residuals) with residuals shape (B,), recomputed from scratch.

    `apply_impl="jnp"` uses the (natively batched) jnp apply and scans —
    the path GSPMD can partition over a mesh."""
    bs = jnp.asarray(bs)
    if bs.ndim != 4:
        raise ValueError(f"bs must be (B, nz, ny, nx); got {bs.shape}")
    shift = jnp.asarray(shift, bs.dtype)
    # Cast to the RHS dtype: a wide extra_diag (e.g. f64 under x64)
    # must not silently promote the whole Krylov recurrence.
    extra = (0.0 if extra_diag is None
             else jnp.asarray(extra_diag, bs.dtype))

    apply_coeffs = transpose_coeffs(coeffs, topology) if transpose else coeffs
    route = kernel_route(interpret) if apply_impl == "pallas" else "jnp"

    def a_op(xs):
        txs = apply_stencil_pallas_multi(apply_coeffs, xs, topology, route)
        return shift * xs + extra * xs + txs

    shifted_diag = shift + extra + coeffs.diag
    if preconditioner == "tridiag":
        m_coeffs = _swap_vertical(coeffs, topology) if transpose else coeffs
        M = _tridiag_preconditioner(m_coeffs, shifted_diag, route)
    elif preconditioner == "jacobi":
        # elementwise; broadcasts over the batch
        M = _jacobi_preconditioner(shifted_diag)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    xs = _bicgstab_matrix_free_multi(a_op, bs, M, tol, maxiter)

    axes = tuple(range(1, bs.ndim))
    rnorm = jnp.sqrt(jnp.sum((a_op(xs) - bs) ** 2, axis=axes))
    bnorm = jnp.sqrt(jnp.sum(bs ** 2, axis=axes))
    res = rnorm / jnp.where(bnorm == 0, 1.0, bnorm)
    return xs, res


def water_mass_fractions(
    coeffs: StencilCoeffs,
    wet3d,
    topology: GridTopology,
    region_masks,
    surface_rate: float = 1.0,
    tol: float = 1e-8,
    apply_impl: str = "pallas",
    preconditioner: str = "tridiag",
):
    """Steady-state surface-origin water-mass fractions, one batched
    solve for ALL regions.

    For a partition of the surface into R regions, fraction r satisfies
    the dye steady state (reference-style restoring, the same M as ideal
    age, test/local_full.jl:155-168):

        (T + M) f_r = M 1_region_r ,   M = surface_rate * 1_surface,

    so f_r(cell) is the fraction of water at `cell` that last contacted
    the surface inside region r. All R solves share T and run as ONE
    lockstep batched Krylov (`solve_shifted_multi`). By linearity the
    fractions of a surface partition sum to the solve with the summed
    right-hand side (the all-surface dye); with T volume-conserving the
    interior sum is ~1. Beyond the reference's workloads, but the
    standard TMIP analysis this operator exists to serve.

    `region_masks` is (R, ny, nx) boolean. Returns (fractions, residuals)
    with fractions (R, nz, ny, nx), NaN on land."""
    wet = jnp.asarray(wet3d, bool)
    dtype = coeffs.diag.dtype
    masks = jnp.asarray(region_masks, bool)
    surf = jnp.zeros(wet.shape, dtype).at[0].set(surface_rate)
    surf = jnp.where(wet, surf, 0.0)
    bs = jnp.where(wet[None] & masks[:, None, :, :], surf[None], 0.0)
    if _use_chunked(apply_impl, None, False, topology):
        # Large grids: the host-chunked batched BiCGStab(2) engine (the
        # advective spectra that stall BiCGStab(1) there affect the dye
        # systems the same way; see CHUNKED_MIN_COLUMNS).
        fr, res = solve_shifted_chunked_multi(
            coeffs, bs, topology, shift=0.0, extra_diag=surf, tol=tol,
            preconditioner=preconditioner, algorithm="bicgstab2",
        )
    else:
        fr, res = solve_shifted_multi(
            coeffs, bs, topology, shift=0.0, extra_diag=surf, tol=tol,
            apply_impl=apply_impl, preconditioner=preconditioner,
        )
    return jnp.where(wet[None], fr, jnp.nan), res


# ---------------------------------------------------------------------------
# Module-level chunk programs for the host-chunked Krylov engines.
#
# These were originally nested closures inside solve_shifted_chunked /
# solve_shifted_chunked_multi — which meant every SOLVE created fresh
# function objects and jax.jit recompiled the whole chunk program per
# call (and the refined ideal age runs 5-7 inner solves). Module-level definitions share one jit cache across
# solves; the former closure variables (topology, preconditioner, route)
# are trailing static arguments.


def _mk_M(mc_l, md_l, preconditioner: str, route: str):
    """The preconditioner apply for the chunk programs: the Thomas solve
    on `route` (one field or a batch), or Jacobi."""
    if preconditioner == "tridiag":
        return _tridiag_preconditioner(mc_l, md_l, route)
    return _jacobi_preconditioner(md_l)


@partial(jax.jit, static_argnums=(4, 5, 6, 7), donate_argnums=(3,))
def _sr_chunk1(c_l, mc_l, md_l, state, nsteps: int, topology: GridTopology,
               preconditioner: str, route: str):
    """`nsteps` BiCGStab(1) iterations as one fori_loop program.
    Device arrays are jit ARGUMENTS (closures would bake multi-GB
    constants into the program); the Krylov state is donated."""
    M = _mk_M(mc_l, md_l, preconditioner, route)

    def a_op(x):
        return apply_stencil(c_l, x, topology)

    def body(_, st):
        x, r, p, rhat0, rho = st
        phat = M(p)
        v = a_op(phat)
        denom = jnp.vdot(rhat0, v)
        alpha = rho / jnp.where(denom == 0, 1.0, denom)
        s = r - alpha * v
        shat = M(s)
        t = a_op(shat)
        tt = jnp.vdot(t, t)
        omega = jnp.vdot(t, s) / jnp.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = jnp.vdot(rhat0, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
            alpha / jnp.where(omega == 0, 1.0, omega)
        )
        p = r + beta * (p - omega * v)
        return (x, r, p, rhat0, rho_new)

    state = jax.lax.fori_loop(0, nsteps, body, state)
    rnorm2 = jnp.vdot(state[1], state[1]).real
    return state, rnorm2


def _bicgstab2_cycles(K, guard, state, ncycles):
    """ncycles of BiCGStab(l=2) (Sleijpen & Fokkema 1993) on the
    right-preconditioned operator K = A o M, y-space state
    (y, r0, u0, rhat, rho0, alpha, omega)."""

    def cycle(_, st):
        y, r0, u0, rhat, rho0, alpha, omega = st
        rho0 = -omega * rho0
        # BiCG step j = 0
        rho1 = jnp.vdot(rhat, r0)
        beta = alpha * rho1 / guard(rho0)
        rho0 = rho1
        u0 = r0 - beta * u0
        u1 = K(u0)
        alpha = rho0 / guard(jnp.vdot(rhat, u1))
        r0 = r0 - alpha * u1
        r1 = K(r0)
        y = y + alpha * u0
        # BiCG step j = 1
        rho1 = jnp.vdot(rhat, r1)
        beta = alpha * rho1 / guard(rho0)
        rho0 = rho1
        u0 = r0 - beta * u0
        u1 = r1 - beta * u1
        u2 = K(u1)
        alpha = rho0 / guard(jnp.vdot(rhat, u2))
        r0 = r0 - alpha * u1
        r1 = r1 - alpha * u2
        r2 = K(r1)
        y = y + alpha * u0
        # 2D minimal-residual polish: min ||r0 - w1 r1 - w2 r2||
        t11 = jnp.vdot(r1, r1)
        t12 = jnp.vdot(r1, r2)
        t22 = jnp.vdot(r2, r2)
        s1 = jnp.vdot(r0, r1)
        s2 = jnp.vdot(r0, r2)
        det = guard(t11 * t22 - t12 * t12)
        w1 = (t22 * s1 - t12 * s2) / det
        w2 = (t11 * s2 - t12 * s1) / det
        y = y + w1 * r0 + w2 * r1
        r0 = r0 - w1 * r1 - w2 * r2
        u0 = u0 - w1 * u1 - w2 * u2
        return (y, r0, u0, rhat, rho0, alpha, w2)

    state = jax.lax.fori_loop(0, ncycles, cycle, state)
    rnorm2 = jnp.vdot(state[1], state[1]).real
    return state, rnorm2


@partial(jax.jit, static_argnums=(4, 5, 6, 7), donate_argnums=(3,))
def _sr_chunk2(c_l, mc_l, md_l, state, ncycles: int, topology: GridTopology,
               preconditioner: str, route: str):
    M = _mk_M(mc_l, md_l, preconditioner, route)

    def K(v):
        return apply_stencil(c_l, M(v), topology)

    one = jnp.ones((), state[0].dtype)
    guard = lambda d: jnp.where(d == 0, one, d)
    return _bicgstab2_cycles(K, guard, state, ncycles)


@partial(jax.jit, static_argnums=(4, 5))
def _sr_apply_M(mc_l, md_l, c_l, y_l, preconditioner: str, route: str):
    return _mk_M(mc_l, md_l, preconditioner, route)(y_l)


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _sr_restart2(c_l, mc_l, md_l, y_l, b_l, topology: GridTopology,
                 preconditioner: str, route: str, jitter: int = 0):
    M = _mk_M(mc_l, md_l, preconditioner, route)
    r = b_l - apply_stencil(c_l, M(y_l), topology)
    zero = jnp.zeros((), b_l.dtype)
    return (y_l + 0.0, r, jnp.zeros_like(r), _jitter_rhat(r, jitter),
            jnp.ones((), b_l.dtype), zero, jnp.ones((), b_l.dtype))


def _jitter_rhat(r, jitter):
    """A perturbed shadow vector for breakdown-recovery restarts.

    A BiCGStab divergence is deterministic: restarting from the same
    iterate with rhat = r replays the identical blow-up (observed: a
    diverged inner refinement pass whose best iterate was x0 made every
    subsequent pass bit-identical, so the refinement could never
    progress). Perturbing rhat (a k-alternating +-10%% modulation,
    scaled by the restart ordinal) changes every <rhat, .> projection
    while preserving land zeros and the overlap with r."""
    if jitter == 0:
        return r + 0.0
    # Cycle the modulation axis per retry ordinal — k, then j, then i
    # (offset by r.ndim - 3 so batched (B, nz, ny, nx) fields modulate
    # their grid axes, never the batch axis): retries whose
    # perturbations differ only in amplitude along the SAME axis can
    # re-excite the same breakdown; a different axis changes the
    # perturbation's structure, not just its size.
    axis = (r.ndim - 3) + (jitter - 1) % 3
    sign = (jax.lax.broadcasted_iota(jnp.int32, r.shape, axis) % 2) * 2 - 1
    return r * (1.0 + jnp.asarray(0.1 * jitter, r.dtype)
                * sign.astype(r.dtype))


@partial(jax.jit, static_argnums=(3, 4, 5))
def _sr_restart1(c_l, x_l, b_l, topology: GridTopology, route: str,
                 jitter: int = 0):
    r = b_l - apply_stencil(c_l, x_l, topology)
    # x copied out of best_x's buffer: the returned state is donated
    # into the next chunk while best_x must survive.
    return (x_l + 0.0, r, r + 0.0, _jitter_rhat(r, jitter),
            jnp.vdot(r, r))


@partial(jax.jit, static_argnums=(3, 4))
def _sr_final_res(c_l, x_l, b_l, topology: GridTopology, route: str):
    r = apply_stencil(c_l, x_l, topology) - b_l
    bn = jnp.sqrt(jnp.vdot(b_l, b_l).real)
    return jnp.sqrt(jnp.vdot(r, r).real) / jnp.where(bn == 0, 1.0, bn)


def solve_shifted_chunked(
    coeffs: StencilCoeffs,
    b,
    topology: GridTopology,
    shift=0.0,
    extra_diag=None,
    tol: float = 1e-10,
    maxiter: int = 2000,
    chunk: int = 50,
    transpose: bool = False,
    preconditioner: str = "tridiag",
    interpret: bool = False,
    verbose: bool = False,
    early_stop: bool = True,
    max_restarts: int = 2,
    algorithm: str = "bicgstab",
    stats: dict | None = None,
    max_diverge_restarts: int = 2,
):
    """`solve_shifted` with the Krylov loop split into host-controlled
    fori_loop chunks, for large grids (see `CHUNKED_MIN_COLUMNS`). The
    Thomas preconditioner runs on `kernel_route(interpret)`.

    `max_diverge_restarts` bounds the DIVERGENCE-specific restarts
    (independent of `max_restarts`, which refinement callers set to 0
    for stall handling): each divergence retry perturbs the shadow
    vector (`_jitter_rhat`) so the replay takes a different Krylov
    trajectory — a diverged pass restarted verbatim from the same
    iterate is deterministic and blows up identically.

    `stats`, if given a dict, is filled with per-solve diagnostics:
    ``iters`` (matvec-pairs used), ``restarts``, ``stop`` (one of
    "converged" / "stall" / "diverged" / "maxiter"), ``start_rel`` /
    ``end_rel`` (recurrence residuals) — so a slow solve's time budget
    is attributable from the artifact alone.

    In-pass DIVERGENCE exit: a chunk sequence whose recurrence residual
    rises above 4x its pass-start value (or goes NaN) is aborted
    immediately — restarted from the best iterate while restart budget
    remains, otherwise returned to the caller (the outer IR loop
    re-evaluates the true defect and refines from the best iterate).
    Round-4 artifacts showed whole 600-iteration passes ending at
    recurrence residuals above 1 while only the outer best-iterate
    machinery rescued the solve; the exit caps that waste at one chunk.

    `algorithm="bicgstab2"` runs BiCGStab(l=2) (Sleijpen & Fokkema 1993)
    instead of BiCGStab(1): each cycle does two BiCG steps followed by a
    TWO-dimensional minimal-residual polish, which handles the
    complex-conjugate eigenvalue pairs of advective operators that drive
    BiCGStab(1)'s omega breakdowns (the observed stall/divergence mode
    of the 0.25-degree defect solves). Same cost per matvec; `maxiter`
    and `chunk` still count matvec-PAIRS (one BiCGStab(1) iteration
    == half a BiCGStab(2) cycle), so budgets are comparable across
    algorithms. The solve runs right-preconditioned in y-space
    (K = A o M, x = M y).

    Each jitted fori_loop call runs `chunk` iterations; the host checks
    convergence between chunks (one scalar fetch each) and applies the
    restart logic above. Whether an on-device `while_loop` would serve
    as well is ROADMAP S6. Not wrapped in jit — callers that jit whole pipelines should use
    `solve_shifted`; this is the standalone/driver path used by
    `ideal_age`/`sequestration_time` on large grids. Same contract:
    returns (x, relative_residual) with the residual recomputed from
    scratch."""
    route = kernel_route(interpret)
    b = jnp.asarray(b)
    shift = jnp.asarray(shift, b.dtype)
    # Cast to the RHS dtype: a wide extra_diag (e.g. f64 under x64)
    # must not silently promote the whole Krylov recurrence.
    extra = (0.0 if extra_diag is None
             else jnp.asarray(extra_diag, b.dtype))
    apply_coeffs = transpose_coeffs(coeffs, topology) if transpose else coeffs

    shifted_diag = shift + extra + coeffs.diag
    if preconditioner not in ("tridiag", "jacobi"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    # (the Jacobi M reads only the diagonal; m_coeffs is threaded anyway)
    m_coeffs = _swap_vertical(coeffs, topology) if transpose else coeffs

    # Pre-bake the scalar shift and the extra diagonal INTO the stencil
    # diagonal: the matvec then needs no post-kernel `shift*x + extra*x`
    # elementwise pass (a ~4-stream HBM pass per operator application —
    # two per Krylov iteration at grid scale). transpose_coeffs keeps
    # the diagonal, so this is valid for adjoint solves too.
    a_coeffs = apply_coeffs._replace(diag=shifted_diag)

    # Chunk programs are MODULE-LEVEL jits (see _sr_chunk1 etc.): the
    # jit cache persists across solves, so repeated solves (e.g. the
    # refinement loop's inner passes) pay zero recompilation.
    bnorm2 = float(jnp.vdot(b, b).real)
    atol2 = (tol ** 2) * bnorm2
    x0 = jnp.zeros_like(b)
    # Fresh buffers for the residual family: the chunk jit DONATES its
    # state, and handing it b's own buffer would invalidate b for
    # final_res below.
    if algorithm == "bicgstab":
        state = (x0, b + 0.0, b + 0.0, b + 0.0, jnp.vdot(b, b))
    elif algorithm == "bicgstab2":
        state = (x0, b + 0.0, jnp.zeros_like(b), b + 0.0,
                 jnp.ones((), b.dtype), jnp.zeros((), b.dtype),
                 jnp.ones((), b.dtype))
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    iters = 0
    chunks_done = 0
    window_rn2 = float("inf")
    # Best-iterate tracking: BiCGStab recurrences on this operator can
    # DIVERGE transiently (omega breakdowns push the recurrence residual
    # orders of magnitude above ||b||, observed in the round-3 0.25-
    # degree refinement logs). Returning the best chunk-boundary iterate
    # instead of the last makes a diverged pass harmless — in the worst
    # case x stays at the best earlier iterate, never garbage. The cost
    # is one extra grid vector and one device copy per improving chunk.
    # Separate allocation: x0 itself sits in the donated state tuple and
    # its buffer dies inside the first run_chunk call.
    best_x = jnp.zeros_like(b)
    best_rn2 = float(jnp.vdot(b, b).real)  # residual at x0 = 0 is b
    restarts = 0
    div_restarts = 0
    div_streak = 0
    diverge_exit_alive = True
    # Residual-norm^2 at the start of the current Krylov pass (a fresh
    # start or the last restart) — the reference point for the in-pass
    # divergence exit.
    pass_rn2 = bnorm2
    rn2 = bnorm2
    stop = "maxiter"

    def do_restart(jitter: int = 0):
        nonlocal state, restarts, window_rn2, pass_rn2, div_streak
        restarts += 1
        div_streak = 0
        state = None  # free the grid vectors before rebuilding
        if algorithm == "bicgstab":
            state = _sr_restart1(a_coeffs, best_x, b, topology, route,
                                 jitter)
        else:
            state = _sr_restart2(a_coeffs, m_coeffs, shifted_diag,
                                 best_x, b, topology, preconditioner,
                                 route, jitter)
        window_rn2 = float("inf")
        pass_rn2 = best_rn2

    import time as _time

    chunk_s = [] if stats is not None else None
    while iters < maxiter:
        _t_chunk = _time.perf_counter()
        nsteps = min(chunk, maxiter - iters)
        if algorithm == "bicgstab":
            state, rnorm2 = _sr_chunk1(a_coeffs, m_coeffs, shifted_diag,
                                       state, nsteps, topology,
                                       preconditioner, route)
            iters += nsteps
        else:
            ncycles = max(1, nsteps // 2)
            state, rnorm2 = _sr_chunk2(a_coeffs, m_coeffs, shifted_diag,
                                       state, ncycles, topology,
                                       preconditioner, route)
            iters += 2 * ncycles
        rn2 = float(rnorm2)
        if chunk_s is not None:
            # wall per chunk INCLUDING the scalar-fetch sync — the
            # slow-first-chunk signature (compile-cache deserialize,
            # kernel upload) vs a uniformly slow pass is readable from
            # the bench artifact alone.
            chunk_s.append(round(_time.perf_counter() - _t_chunk, 4))
        if rn2 < best_rn2:  # NaN-safe: NaN compares False
            best_rn2 = rn2
            best_x = state[0] + 0.0  # copy: state is donated next chunk
        if verbose:
            import sys as _sys

            print(f"#   chunked iter {iters}: rel recurrence residual "
                  f"{(rn2 / bnorm2) ** 0.5:.3e}", file=_sys.stderr)
        if rn2 <= atol2:
            stop = "converged"
            break
        # In-pass DIVERGENCE exit: recurrence residual above 4x its
        # pass-start value for TWO CONSECUTIVE chunk boundaries (or NaN)
        # means this Krylov space is likely lost. The persistence
        # requirement matters: BiCGStab(2) trajectories on the advective
        # defect systems routinely spike past 4x and then recover to
        # useful contractions (round-4 artifacts: passes that blew up
        # mid-pass still delivered 37x contractions at later chunk
        # boundaries) — a single-boundary exit aborted exactly those
        # passes and floored the in-bench 0.25-degree solve at 3.5e-3.
        if not rn2 <= 16.0 * pass_rn2:  # NaN-safe: NaN -> diverged
            div_streak = div_streak + 1 if rn2 == rn2 else 2  # NaN: now
        else:
            div_streak = 0
        if div_streak >= 2 and diverge_exit_alive:
            div_streak = 0
            # Divergence restarts have their OWN budget (independent of
            # the stall budget, which refinement callers set to 0): a
            # blow-up replayed from the same state is deterministic, so
            # each retry perturbs the shadow vector (_jitter_rhat) to
            # change the Krylov trajectory.
            if div_restarts < max_diverge_restarts:
                div_restarts += 1
                if verbose:
                    import sys as _sys

                    print(f"#   chunked iter {iters}: DIVERGED "
                          f"(rel {(rn2 / bnorm2) ** 0.5:.3e}); jittered "
                          f"restart {div_restarts} from best iterate",
                          file=_sys.stderr)
                do_restart(jitter=div_restarts)
                continue
            if best_rn2 < pass_rn2 or rn2 != rn2:
                # progress exists worth protecting (hand the best
                # iterate back instead of risking it on a lost space) —
                # or the recurrence is NaN, which never recovers
                stop = "diverged"
                break
            # No progress at all, finite recurrence, jitter budget
            # spent: the exit has nothing to protect. Fall back to
            # letting the recurrence run (round-4 semantics) — blow-up-
            # then-recover trajectories reach useful contractions, and
            # the stall window / maxiter still bound the waste.
            diverge_exit_alive = False
        # f32-floor detection on CUMULATIVE progress: a slowly-but-
        # genuinely converging solve shrinks the residual a little every
        # chunk, which a per-chunk threshold would misread as stagnation.
        # Only when a whole 3-chunk window TOGETHER fails to improve the
        # residual NORM by even 2% has the recurrence hit its rounding
        # floor — then burning the remaining maxiter cannot help.
        chunks_done += 1
        if early_stop and chunks_done % 3 == 0:
            if rn2 >= (0.98 ** 2) * window_rn2:
                if restarts < max_restarts:
                    # BiCGStab plateaus are usually rhat0 losing its
                    # overlap with r (near-breakdown omegas). RESTART
                    # from the best iterate with a fresh Krylov space:
                    # recompute the true residual r = b - A x_best and
                    # reset rhat0 = p = r — the standard breakdown
                    # remedy, one extra matvec per restart.
                    if verbose:
                        import sys as _sys

                        print(f"#   chunked iter {iters}: window "
                              f"stalled; restart {restarts + 1} from "
                              f"best iterate", file=_sys.stderr)
                    do_restart()
                    continue
                import warnings

                warnings.warn(
                    f"solve_shifted_chunked: relative residual "
                    f"{(rn2 / bnorm2) ** 0.5:.3e} after {iters} iterations "
                    f"improved <2% over the last {3 * chunk} iterations "
                    f"(after {restarts} restart(s)) — likely the f32 "
                    f"rounding floor; wrap in solve_shifted_ir for "
                    f"tighter residuals, or pass early_stop=False to "
                    f"keep iterating.",
                    stacklevel=2,
                )
                stop = "stall"
                break
            window_rn2 = rn2

    # NaN-safe best-iterate selection: take the last iterate only when
    # its recurrence residual is a number AND strictly beats the best
    # chunk-boundary iterate (advisor round 4: `best_rn2 < NaN` is
    # False, which returned the garbage last iterate).
    take_last = rn2 < best_rn2
    x = state[0] if take_last else best_x
    if stats is not None:
        bn = bnorm2 ** 0.5 if bnorm2 > 0 else 1.0
        sel_rn2 = rn2 if take_last else best_rn2
        stats.update(
            iters=iters, restarts=restarts, stop=stop,
            diverge_restarts=div_restarts,
            start_rel=1.0, end_rel=(sel_rn2 ** 0.5) / bn,
            chunk_s=chunk_s,
        )
    if algorithm == "bicgstab2":
        # the bicgstab2 state lives in right-preconditioned y-space
        x = _sr_apply_M(m_coeffs, shifted_diag, a_coeffs, x,
                        preconditioner, route)

    res = _sr_final_res(a_coeffs, x, b, topology, route)
    return x, res


# Module-level chunk programs for the BATCHED chunked engine (same
# jit-cache-persistence rationale as _sr_chunk1 above).

_mdot = lambda u, v: jnp.sum(u * v, axis=(1, 2, 3))  # (B,); real fields
_mbx = lambda s: s[:, None, None, None]


@partial(jax.jit, static_argnums=(4, 5, 6, 7), donate_argnums=(3,))
def _mr_chunk1(c_l, mc_l, md_l, state, nsteps: int, topology: GridTopology,
               preconditioner: str, route: str):
    M = _mk_M(mc_l, md_l, preconditioner, route)

    def a_op(xs):
        return apply_stencil_pallas_multi(c_l, xs, topology, route)

    dot, bx = _mdot, _mbx

    def body(_, st):
        xs, r, p, rhat0, rho = st
        phat = M(p)
        v = a_op(phat)
        denom = dot(rhat0, v)
        alpha = rho / jnp.where(denom == 0, 1.0, denom)
        s = r - bx(alpha) * v
        shat = M(s)
        t = a_op(shat)
        tt = dot(t, t)
        omega = dot(t, s) / jnp.where(tt == 0, 1.0, tt)
        xs = xs + bx(alpha) * phat + bx(omega) * shat
        r = s - bx(omega) * t
        rho_new = dot(rhat0, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
            alpha / jnp.where(omega == 0, 1.0, omega)
        )
        p = r + bx(beta) * (p - bx(omega) * v)
        return (xs, r, p, rhat0, rho_new)

    state = jax.lax.fori_loop(0, nsteps, body, state)
    rnorm2 = _mdot(state[1], state[1])
    return state, rnorm2


@partial(jax.jit, static_argnums=(4, 5, 6, 7), donate_argnums=(3,))
def _mr_chunk2(c_l, mc_l, md_l, state, ncycles: int, topology: GridTopology,
               preconditioner: str, route: str):
    M = _mk_M(mc_l, md_l, preconditioner, route)

    def K(vs):
        return apply_stencil_pallas_multi(c_l, M(vs), topology, route)

    dot, bx = _mdot, _mbx
    one = jnp.ones((), state[0].dtype)
    guard = lambda d: jnp.where(d == 0, one, d)

    def cycle(_, st):
        y, r0, u0, rhat, rho0, alpha, omega = st
        rho0 = -omega * rho0
        # BiCG step j = 0 (per-member scalars, shape (B,))
        rho1 = dot(rhat, r0)
        beta = alpha * rho1 / guard(rho0)
        rho0 = rho1
        u0 = r0 - bx(beta) * u0
        u1 = K(u0)
        alpha = rho0 / guard(dot(rhat, u1))
        r0 = r0 - bx(alpha) * u1
        r1 = K(r0)
        y = y + bx(alpha) * u0
        # BiCG step j = 1
        rho1 = dot(rhat, r1)
        beta = alpha * rho1 / guard(rho0)
        rho0 = rho1
        u0 = r0 - bx(beta) * u0
        u1 = r1 - bx(beta) * u1
        u2 = K(u1)
        alpha = rho0 / guard(dot(rhat, u2))
        r0 = r0 - bx(alpha) * u1
        r1 = r1 - bx(alpha) * u2
        r2 = K(r1)
        y = y + bx(alpha) * u0
        # per-member 2D minimal-residual polish
        t11 = dot(r1, r1)
        t12 = dot(r1, r2)
        t22 = dot(r2, r2)
        s1 = dot(r0, r1)
        s2 = dot(r0, r2)
        det = guard(t11 * t22 - t12 * t12)
        w1 = (t22 * s1 - t12 * s2) / det
        w2 = (t11 * s2 - t12 * s1) / det
        y = y + bx(w1) * r0 + bx(w2) * r1
        r0 = r0 - bx(w1) * r1 - bx(w2) * r2
        u0 = u0 - bx(w1) * u1 - bx(w2) * u2
        return (y, r0, u0, rhat, rho0, alpha, w2)

    state = jax.lax.fori_loop(0, ncycles, cycle, state)
    rnorm2 = _mdot(state[1], state[1])
    return state, rnorm2


@partial(jax.jit, static_argnums=(4, 5))
def _mr_apply_M(mc_l, md_l, c_l, y_l, preconditioner: str, route: str):
    return _mk_M(mc_l, md_l, preconditioner, route)(y_l)


@partial(jax.jit)
def _mr_keep_best(best_xs, best_rn2_d, xs_now, rn2_now):
    better = rn2_now < best_rn2_d
    sel = better[:, None, None, None]
    return (jnp.where(sel, xs_now, best_xs),
            jnp.where(better, rn2_now, best_rn2_d))


def _mr_blend(old, new, mask_d):
    """new where mask (per member), old elsewhere, across a state tuple
    of (B, ...) vectors and (B,) scalars."""
    pick = lambda o, n: jnp.where(
        mask_d[(slice(None),) + (None,) * (o.ndim - 1)], n, o)
    return tuple(pick(o, n) for o, n in zip(old, new))


@partial(jax.jit, static_argnums=(5, 6, 7), donate_argnums=(1,))
def _mr_restart_members(c_l, state_old, xs_best, bs_l, mask_d,
                        topology: GridTopology, route: str,
                        jitter: int = 0):
    """Fresh Krylov space from the best iterate for the members in
    `mask_d` only; other members' state passes through untouched."""
    r = bs_l - apply_stencil_pallas_multi(c_l, xs_best, topology, route)
    new = (xs_best + 0.0, r, r + 0.0, _jitter_rhat(r, jitter),
           _mdot(r, r))
    return _mr_blend(state_old, new, mask_d)


@partial(jax.jit, static_argnums=(7, 8, 9, 10), donate_argnums=(3,))
def _mr_restart_members2(c_l, mc_l, md_l, state_old, xs_best, bs_l, mask_d,
                         topology: GridTopology, preconditioner: str,
                         route: str, jitter: int = 0):
    M = _mk_M(mc_l, md_l, preconditioner, route)
    r = bs_l - apply_stencil_pallas_multi(c_l, M(xs_best), topology,
                                          route)
    B = bs_l.shape[0]
    ones_b = jnp.ones((B,), bs_l.dtype)
    new = (xs_best + 0.0, r, jnp.zeros_like(r), _jitter_rhat(r, jitter),
           ones_b, jnp.zeros((B,), bs_l.dtype), ones_b)
    return _mr_blend(state_old, new, mask_d)


@partial(jax.jit, static_argnums=(3, 4))
def _mr_final_res(c_l, xs_l, bs_l, topology: GridTopology, route: str):
    r = apply_stencil_pallas_multi(c_l, xs_l, topology, route) - bs_l
    bn = jnp.sqrt(_mdot(bs_l, bs_l))
    return jnp.sqrt(_mdot(r, r)) / jnp.where(bn == 0, 1.0, bn)


def solve_shifted_chunked_multi(
    coeffs: StencilCoeffs,
    bs,
    topology: GridTopology,
    shift=0.0,
    extra_diag=None,
    tol: float = 1e-10,
    maxiter: int = 2000,
    chunk: int = 50,
    transpose: bool = False,
    preconditioner: str = "tridiag",
    interpret: bool = False,
    verbose: bool = False,
    early_stop: bool = True,
    max_restarts: int = 2,
    algorithm: str = "bicgstab",
    stats: dict | None = None,
    max_diverge_restarts: int = 2,
):
    """`solve_shifted_multi` with the lockstep batched Krylov loop split
    into host-controlled fori_loop chunks — the batched analogue of
    `solve_shifted_chunked`, for large grids.

    All B solves share one operator, so the matvec runs through the
    batched stencil kernel (coefficients read once per tile and shared
    across the batch: per-solve traffic 2 + 7/B streams instead of 9)
    and the Thomas preconditioner through its kernel, both on
    `kernel_route(interpret)`. Same contract as `solve_shifted_multi`:
    `bs` is (B, nz, ny, nx); returns (xs, residuals) with residuals
    shape (B,), recomputed from scratch. The chunk boundary checks EVERY
    batch member's recurrence residual and stops only when all meet
    `tol` (converged members idle harmlessly through the zero-division
    guards, exactly as in `_bicgstab_matrix_free_multi`). Stall and
    divergence handling is PER MEMBER: converged members are masked out
    of the window test, and a restart rebuilds a fresh Krylov space only
    for the members that need it, leaving the others' subspaces intact.
    `stats` as in `solve_shifted_chunked` (``end_rel`` is the worst
    member's).

    `algorithm="bicgstab2"` runs per-member BiCGStab(l=2) in lockstep
    (see `solve_shifted_chunked`): two BiCG steps + a per-member 2D
    minimal-residual polish per cycle, right-preconditioned in y-space.
    `maxiter`/`chunk` still count matvec-pairs.
    """
    route = kernel_route(interpret)
    bs = jnp.asarray(bs)
    if bs.ndim != 4:
        raise ValueError(f"bs must be (B, nz, ny, nx); got {bs.shape}")
    shift = jnp.asarray(shift, bs.dtype)
    # Cast to the RHS dtype: a wide extra_diag (e.g. f64 under x64)
    # must not silently promote the whole Krylov recurrence.
    extra = (0.0 if extra_diag is None
             else jnp.asarray(extra_diag, bs.dtype))
    apply_coeffs = transpose_coeffs(coeffs, topology) if transpose else coeffs

    shifted_diag = shift + extra + coeffs.diag
    if preconditioner not in ("tridiag", "jacobi"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    # (the Jacobi M reads only the diagonal; m_coeffs is threaded anyway)
    m_coeffs = _swap_vertical(coeffs, topology) if transpose else coeffs

    axes = (1, 2, 3)
    dot = lambda u, v: jnp.sum(u * v, axis=axes)  # (B,); fields are real
    bx = lambda s: s[:, None, None, None]

    # Shift and extra diagonal pre-baked into the stencil diagonal: no
    # post-kernel elementwise pass per batched matvec (see
    # solve_shifted_chunked).
    a_coeffs = apply_coeffs._replace(diag=shifted_diag)

    # Chunk programs are MODULE-LEVEL jits (_mr_chunk1 etc.): the jit
    # cache persists across solves — zero per-solve recompilation.
    bnorm2 = dot(bs, bs)
    atol2 = np.asarray((tol ** 2) * bnorm2)
    x0 = jnp.zeros_like(bs)
    # Fresh buffers for the residual family: the chunk jit DONATES its
    # state.
    B = bs.shape[0]
    if algorithm == "bicgstab":
        state = (x0, bs + 0.0, bs + 0.0, bs + 0.0, dot(bs, bs))
    elif algorithm == "bicgstab2":
        state = (x0, bs + 0.0, jnp.zeros_like(bs), bs + 0.0,
                 jnp.ones((B,), bs.dtype), jnp.zeros((B,), bs.dtype),
                 jnp.ones((B,), bs.dtype))
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    iters = 0
    chunks_done = 0
    bn2_np = np.asarray(bnorm2)
    bn2_safe = np.where(bn2_np == 0, 1.0, bn2_np)
    # Per-member window / pass-start residuals (host copies): converged
    # members are MASKED OUT of the stall/divergence logic, and restarts
    # are applied PER MEMBER — one stalled member no longer waits for
    # (or disturbs) the rest of the batch (advisor round 4: the old
    # all-member window test let one slowly-improving member suppress
    # the restart that a genuinely stalled member needed).
    window_rn2 = np.full((B,), np.inf)
    pass_rn2 = bn2_np.copy()
    stop = "maxiter"

    # Separate allocation: x0 itself sits in the donated state tuple and
    # its buffer dies inside the first chunk call.
    best_xs = jnp.zeros_like(bs)
    best_rn2 = dot(bs, bs)  # residual at x0 = 0 is b
    restarts = 0
    div_restarts = 0
    div_streak_m = np.zeros((B,), np.int64)
    diverge_exit_alive = True

    def do_restart(mask, jitter: int = 0, count: bool = True):
        nonlocal state, restarts, window_rn2, pass_rn2, div_streak_m
        if count:
            restarts += 1
        div_streak_m = np.where(mask, 0, div_streak_m)
        mask_d = jnp.asarray(mask)
        if algorithm == "bicgstab":
            state = _mr_restart_members(a_coeffs, state, best_xs, bs,
                                        mask_d, topology, route,
                                        jitter)
        else:
            state = _mr_restart_members2(a_coeffs, m_coeffs, shifted_diag,
                                         state, best_xs, bs, mask_d,
                                         topology, preconditioner,
                                         route, jitter)
        window_rn2 = np.where(mask, np.inf, window_rn2)
        pass_rn2 = np.where(mask, np.asarray(best_rn2), pass_rn2)

    while iters < maxiter:
        nsteps = min(chunk, maxiter - iters)
        if algorithm == "bicgstab":
            state, rnorm2 = _mr_chunk1(a_coeffs, m_coeffs, shifted_diag,
                                       state, nsteps, topology,
                                       preconditioner, route)
            iters += nsteps
        else:
            ncycles = max(1, nsteps // 2)
            state, rnorm2 = _mr_chunk2(a_coeffs, m_coeffs, shifted_diag,
                                       state, ncycles, topology,
                                       preconditioner, route)
            iters += 2 * ncycles
        best_xs, best_rn2 = _mr_keep_best(best_xs, best_rn2, state[0],
                                          rnorm2)
        rn2 = np.asarray(rnorm2)
        if verbose:
            import sys as _sys

            rel = np.sqrt(rn2 / bn2_safe)
            print(f"#   chunked-multi iter {iters}: rel recurrence "
                  f"residuals {np.array2string(rel, precision=2)}",
                  file=_sys.stderr)
        if bool((rn2 <= atol2).all()):
            stop = "converged"
            break
        active = ~(rn2 <= atol2)  # NaN counts as active
        # In-pass divergence exit, per member (see
        # solve_shifted_chunked): recurrence above 4x pass-start for TWO
        # CONSECUTIVE chunk boundaries (NaN: immediately). Persistence
        # matters — single-boundary exits aborted blow-up-then-recover
        # trajectories that deliver useful contractions (see the
        # single-RHS engine's comment). Divergence restarts have their
        # OWN budget (independent of the stall budget, which refinement
        # callers set to 0), and each retry perturbs the shadow vector —
        # a diverged member restarted verbatim replays the identical
        # blow-up (see _jitter_rhat).
        over = active & ~(rn2 <= 16.0 * pass_rn2)
        div_streak_m = np.where(over, div_streak_m + 1, 0)
        div_streak_m = np.where(rn2 != rn2, 2, div_streak_m)  # NaN: now
        diverged = div_streak_m >= 2
        if diverge_exit_alive and bool(diverged.any()):
            div_streak_m = np.where(diverged, 0, div_streak_m)
            if div_restarts < max_diverge_restarts:
                div_restarts += 1
                if verbose:
                    import sys as _sys

                    print(f"#   chunked-multi iter {iters}: members "
                          f"{np.flatnonzero(diverged).tolist()} diverged;"
                          f" jittered restart {div_restarts}",
                          file=_sys.stderr)
                do_restart(diverged, jitter=div_restarts, count=False)
                continue
            no_prog = diverged & ~(np.asarray(best_rn2) < pass_rn2)
            if bool((no_prog & (rn2 == rn2)).any()):
                # a diverged member with NO progress to protect, a
                # finite recurrence, and a spent jitter budget: the exit
                # would return x0 for it. Disable the divergence exits
                # and let the recurrences run (round-4 semantics); stall
                # window/maxiter bound the waste and best-iterate
                # tracking protects the rest. (NaN members are excluded:
                # a NaN recurrence never recovers.)
                diverge_exit_alive = False
            elif bool((diverged | ~active).all()):
                stop = "diverged"
                break
            # some members still converging: let them finish; the
            # diverged ones are protected by their best iterates
        # Cumulative 3-chunk-window early stop on the still-active
        # members (converged members masked out).
        chunks_done += 1
        if early_stop and chunks_done % 3 == 0:
            stalled = active & ~(rn2 < (0.98 ** 2) * window_rn2)
            if bool(stalled.any()):
                if restarts < max_restarts:
                    do_restart(stalled)
                    continue
                if bool((stalled | ~active).all()):
                    import warnings

                    worst = float(np.sqrt((rn2 / bn2_safe).max()))
                    warnings.warn(
                        f"solve_shifted_chunked_multi: worst relative "
                        f"residual {worst:.3e} after {iters} iterations "
                        f"improved <2% over the last {3 * chunk} "
                        f"iterations (after {restarts} restart(s)) — "
                        f"likely the f32 rounding floor; wrap in "
                        f"solve_shifted_ir or pass early_stop=False.",
                        stacklevel=2,
                    )
                    stop = "stall"
                    break
            window_rn2 = rn2
    xs = best_xs
    if stats is not None:
        best_np = np.asarray(best_rn2)
        stats.update(
            iters=iters, restarts=restarts, stop=stop,
            diverge_restarts=div_restarts,
            start_rel=1.0,
            end_rel=float(np.sqrt((best_np / bn2_safe).max())),
        )
    if algorithm == "bicgstab2":
        # the bicgstab2 state lives in right-preconditioned y-space
        xs = _mr_apply_M(m_coeffs, shifted_diag, a_coeffs, xs,
                         preconditioner, route)

    res = _mr_final_res(a_coeffs, xs, bs, topology, route)
    return xs, res
