"""Solver layer: explicit/implicit stepping and the ideal-age workload."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from otmb_tpu.grid.indices import wet_vector
from otmb_tpu.models.solvers import (
    explicit_euler_propagate,
    ideal_age,
    implicit_euler_step,
)
from otmb_tpu.models.transport import transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
from otmb_tpu.utils.sparse_export import coeffs_to_scipy


@pytest.fixture(scope="module")
def ops(dataset, gridmetrics, indices):
    phi = facefluxesfrommasstransport(
        umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics, indices=indices
    )
    return transportmatrix(
        phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics, indices=indices
    )


def test_explicit_propagate_conserves_mass(ops, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(1)
    chi = np.where(wet, 1.0 + 0.1 * rng.standard_normal(gridmetrics.shape), 0.0)
    v = np.where(wet, np.asarray(gridmetrics.v3d), 0.0)
    dt = 0.25 / float(np.abs(np.asarray(ops.T.diag)).max())

    out = np.asarray(
        explicit_euler_propagate(ops.T, chi, dt, 200, gridmetrics.topology)
    )
    m0 = float((chi * v).sum())
    m1 = float((out * v).sum())
    assert abs(m1 - m0) / abs(m0) < 1e-12
    assert np.all(out[~wet] == 0.0)
    assert np.isfinite(out[wet]).all()


def test_implicit_step_matches_direct_solve(ops, gridmetrics, indices):
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(2)
    chi = np.where(wet, 1.0 + 0.1 * rng.standard_normal(gridmetrics.shape), 0.0)
    dt = 1e5  # way beyond the explicit CFL limit

    out, res = implicit_euler_step(ops.T, chi, dt, gridmetrics.topology, tol=1e-12)
    out = np.asarray(out)
    assert float(res) < 1e-8

    mat = coeffs_to_scipy(ops.T, indices, gridmetrics.topology)
    n = mat.shape[0]
    import scipy.sparse as sp

    direct = spla.spsolve(
        (sp.identity(n) + dt * mat).tocsc(), wet_vector(chi, indices)
    )
    np.testing.assert_allclose(wet_vector(out, indices), direct, rtol=1e-6, atol=1e-10)


def test_ideal_age(ops, gridmetrics, indices):
    """Mirror of the reference ideal-age range check
    (test/local_full.jl:165-188): 0 < volume-weighted mean age < 2000 yr,
    and agreement with the host direct solve."""
    wet = np.asarray(indices.wet3d)
    gamma, res = ideal_age(ops.T, indices.wet3d, gridmetrics.topology, tol=1e-10)
    gamma = np.asarray(gamma)
    assert float(res) < 1e-6

    yr = 365.25 * 24 * 3600
    v = np.asarray(gridmetrics.v3d)[wet]
    mean_age_yr = float((gamma[wet] * v).sum() / v.sum()) / yr
    assert 0.0 < mean_age_yr < 2000.0

    # cross-check vs scipy direct solve of (T + M) x = 1
    import scipy.sparse as sp

    mat = coeffs_to_scipy(ops.T, indices, gridmetrics.topology)
    surf = np.zeros(gridmetrics.shape, bool)
    surf[0] = True
    m_diag = wet_vector(np.where(surf & wet, 1.0, 0.0), indices)
    direct = spla.spsolve((mat + sp.diags(m_diag)).tocsc(), np.ones(mat.shape[0]))
    np.testing.assert_allclose(gamma[wet], direct, rtol=1e-5, atol=1e-3)


def test_ideal_age_pallas_apply(ops, gridmetrics, indices):
    """The single-chip fast path (apply_impl='pallas', interpret mode on
    CPU) reproduces the jnp-apply solve."""
    ref, _ = ideal_age(ops.T, indices.wet3d, gridmetrics.topology, tol=1e-10)
    out, res = ideal_age(
        ops.T, indices.wet3d, gridmetrics.topology, tol=1e-10,
        apply_impl="pallas",
    )
    assert float(res) < 1e-6
    wet = np.asarray(indices.wet3d)
    np.testing.assert_allclose(
        np.asarray(out)[wet], np.asarray(ref)[wet], rtol=1e-6, atol=1e-4
    )


def test_tridiag_preconditioner_exact_on_vertical_operator(
    dataset, gridmetrics, indices
):
    """M^-1 applied to the *purely vertical* operator must be an exact
    inverse: one preconditioner application solves (shift I + TkV) x = b."""
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import _tridiag_preconditioner
    from otmb_tpu.models.transport import buildTkVML, buildTkVdeep
    from otmb_tpu.ops.apply import apply_stencil
    from otmb_tpu.ops.coeffs import add_coeffs

    tkv = add_coeffs(
        buildTkVML(mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                   indices=indices),
        buildTkVdeep(gridmetrics=gridmetrics, indices=indices),
    )
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(0)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
    shift = 1e-7

    m_inv = _tridiag_preconditioner(tkv, shift + tkv.diag)
    x = np.asarray(m_inv(jnp.asarray(b)))
    resid = shift * x + np.asarray(
        apply_stencil(tkv, x, gridmetrics.topology)
    ) - b
    assert np.abs(resid[wet]).max() < 1e-8 * max(1.0, np.abs(b).max())


def test_tridiag_preconditioner_solves_full_system(ops, gridmetrics, indices):
    """Both preconditioners must solve the ideal-age system on the full
    operator; the tridiag one additionally handles a severely stiff
    implicit step (huge dt, vertical terms dominant) in few iterations."""
    from otmb_tpu.models.solvers import solve_shifted

    wet = np.asarray(indices.wet3d)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)

    for precond in ("jacobi", "tridiag"):
        _, res = solve_shifted(
            ops.T, ones, gridmetrics.topology, extra_diag=surf, tol=1e-12,
            maxiter=200, preconditioner=precond,
        )
        assert float(res) < 1e-8, precond

    # stiff implicit step, tight iteration budget: tridiag must still converge
    _, res_t = solve_shifted(
        ops.T, ones, gridmetrics.topology, shift=1e-9, tol=1e-12,
        maxiter=60, preconditioner="tridiag",
    )
    assert float(res_t) < 1e-6


def test_sequestration_with_tridiag(ops, gridmetrics, indices):
    from otmb_tpu.models.solvers import sequestration_time

    wet = np.asarray(indices.wet3d)
    gamma, res = sequestration_time(ops.T, indices.wet3d, gridmetrics.topology)
    assert float(res) < 1e-6
    assert np.isfinite(np.asarray(gamma)[wet]).all()


def test_ideal_age_iterative_refinement(ops, gridmetrics, indices):
    """f32 coefficients + mixed-precision refinement reach residuals far
    below the f32 Krylov floor, and the age field matches the f64 solve."""
    import jax

    c32 = jax.tree_util.tree_map(
        lambda a: a.astype(np.float32), ops.T
    )
    wet = np.asarray(indices.wet3d)
    gamma, res = ideal_age(
        c32, indices.wet3d, gridmetrics.topology, tol=1e-9, refine=True
    )
    assert float(res) < 1e-9  # vs its own (promoted) operator

    ref, _ = ideal_age(ops.T, indices.wet3d, gridmetrics.topology, tol=1e-10)
    # the operators differ by f32 coefficient rounding (~1e-7 relative)
    np.testing.assert_allclose(
        np.asarray(gamma)[wet], np.asarray(ref)[wet], rtol=1e-3, atol=1.0
    )


def test_sequestration_time_iterative_refinement(ops, gridmetrics, indices):
    """Refined transpose solve: residual below f32 floor."""
    import jax

    from otmb_tpu.models.solvers import sequestration_time

    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    gd, res = sequestration_time(
        c32, indices.wet3d, gridmetrics.topology, tol=1e-9, refine=True
    )
    assert float(res) < 1e-9
    wet = np.asarray(indices.wet3d)
    assert np.isfinite(np.asarray(gd)[wet]).all()


def test_transpose_coeffs_matches_transpose_apply(ops, gridmetrics, indices):
    """apply_stencil(transpose_coeffs(T), x) == apply_stencil_transpose(T, x)
    — the stencil form of T' feeding the forward (Pallas-capable) apply,
    including the tripolar fold case."""
    from otmb_tpu.ops.apply import (
        apply_stencil,
        apply_stencil_transpose,
        transpose_coeffs,
    )

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(7)
    x = np.where(wet, rng.standard_normal(wet.shape), 0.0)

    ref = np.asarray(apply_stencil_transpose(ops.T, x, topo))
    ct = transpose_coeffs(ops.T, topo)
    got = np.asarray(apply_stencil(ct, x, topo))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-18)

    # involution: (T')' == T, leg by leg
    back = transpose_coeffs(ct, topo)
    for leg, orig in zip(back, ops.T):
        np.testing.assert_allclose(np.asarray(leg), np.asarray(orig),
                                   rtol=1e-12, atol=0.0)


def test_sequestration_time_pallas_apply(ops, gridmetrics, indices):
    """Adjoint solve through the Pallas fast path (interpret mode on CPU)
    reproduces the jnp transpose solve."""
    from otmb_tpu.models.solvers import sequestration_time

    ref, _ = sequestration_time(
        ops.T, indices.wet3d, gridmetrics.topology, tol=1e-10
    )
    out, res = sequestration_time(
        ops.T, indices.wet3d, gridmetrics.topology, tol=1e-10,
        apply_impl="pallas",
    )
    assert float(res) < 1e-6
    wet = np.asarray(indices.wet3d)
    np.testing.assert_allclose(
        np.asarray(out)[wet], np.asarray(ref)[wet], rtol=1e-6, atol=1e-4
    )


@pytest.mark.parametrize("transpose", [False, True])
def test_solve_shifted_multi_matches_per_rhs(ops, gridmetrics, indices,
                                             transpose):
    """Batched lockstep BiCGStab == per-RHS solve_shifted, forward and
    transpose, for a batch of independent right-hand sides."""
    from otmb_tpu.models.solvers import solve_shifted, solve_shifted_multi

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(19)
    B = 3
    bs = np.where(wet[None], rng.standard_normal((B,) + gridmetrics.shape),
                  0.0)
    xs, res = solve_shifted_multi(
        ops.T, bs, topo, shift=1e-4, tol=1e-12, transpose=transpose,
        apply_impl="jnp",
    )
    assert res.shape == (B,)
    assert float(res.max()) < 1e-10
    for b in range(B):
        ref, rres = solve_shifted(
            ops.T, bs[b], topo, shift=1e-4, tol=1e-12, transpose=transpose,
        )
        assert float(rres) < 1e-10
        np.testing.assert_allclose(
            np.asarray(xs[b]), np.asarray(ref), rtol=1e-7, atol=1e-9
        )


def test_solve_shifted_multi_pallas_interpret(ops, gridmetrics, indices):
    """The batched-Pallas matvec route (interpret mode on CPU) solves to
    the same tolerance."""
    from otmb_tpu.models.solvers import solve_shifted, solve_shifted_multi

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(23)
    bs = np.where(wet[None], rng.standard_normal((2,) + gridmetrics.shape),
                  0.0)
    xs, res = solve_shifted_multi(
        ops.T, bs, topo, shift=1e-4, tol=1e-12, apply_impl="pallas",
    )
    assert float(res.max()) < 1e-10
    ref, _ = solve_shifted(ops.T, bs[0], topo, shift=1e-4, tol=1e-12)
    np.testing.assert_allclose(
        np.asarray(xs[0]), np.asarray(ref), rtol=1e-7, atol=1e-9
    )


def test_water_mass_fractions_partition(ops, gridmetrics, indices):
    """Fractions from a surface partition: each in [0, ~1], and by
    linearity their sum equals the single all-surface dye solve."""
    from otmb_tpu.models.solvers import (
        solve_shifted,
        water_mass_fractions,
    )

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    ny, nx = gridmetrics.shape[1:]
    # three-band surface partition by longitude
    i = np.arange(nx)
    masks = np.stack([
        np.broadcast_to(i < nx // 3, (ny, nx)),
        np.broadcast_to((i >= nx // 3) & (i < 2 * nx // 3), (ny, nx)),
        np.broadcast_to(i >= 2 * nx // 3, (ny, nx)),
    ])
    fr, res = water_mass_fractions(
        ops.T, indices.wet3d, topo, masks, tol=1e-13, apply_impl="jnp"
    )
    assert float(res.max()) < 1e-11
    frv = np.asarray(fr)[:, wet]
    assert np.nanmin(frv) > -1e-6
    # the upwind T's surface rows are not exactly divergence-free
    # (evaporation/precipitation, matrixbuilding.jl:290), so dye steady
    # states may overshoot 1 by that small imbalance
    assert np.nanmax(frv) < 1.0 + 1e-4

    # linearity: sum of fractions == all-surface dye solve
    dtype = np.asarray(ops.T.diag).dtype
    surf = np.zeros(wet.shape, dtype)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    ref, rres = solve_shifted(
        ops.T, surf, topo, shift=0.0, extra_diag=surf, tol=1e-13
    )
    assert float(rres) < 1e-11
    # ||A^-1|| is the age scale (~1e9 s), so a 1e-13 relative residual
    # still allows ~1e-4 absolute solution differences between
    # independently converged Krylov runs; linearity holds to that.
    np.testing.assert_allclose(
        np.asarray(fr.sum(axis=0))[wet], np.asarray(ref)[wet],
        rtol=1e-3, atol=1e-3,
    )


@pytest.mark.parametrize("transpose", [False, True])
def test_solve_shifted_chunked_matches_whole_solve(ops, gridmetrics,
                                                   indices, transpose):
    """The host-chunked Krylov (fori_loop chunks + host convergence
    checks — the large-grid engine) solves to the same
    tolerance and solution as the single-jit solve."""
    from otmb_tpu.models.solvers import solve_shifted, solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(29)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)

    x_ref, res_ref = solve_shifted(
        ops.T, b, topo, shift=1e-4, tol=1e-12, transpose=transpose
    )
    x_ch, res_ch = solve_shifted_chunked(
        ops.T, b, topo, shift=1e-4, tol=1e-12, transpose=transpose,
        chunk=7,
    )
    assert float(res_ref) < 1e-10
    assert float(res_ch) < 1e-10
    np.testing.assert_allclose(
        np.asarray(x_ch), np.asarray(x_ref), rtol=1e-7, atol=1e-9
    )


def test_solve_shifted_chunked_maxiter_cap(ops, gridmetrics, indices):
    """The host loop respects maxiter and returns the honest residual."""
    from otmb_tpu.models.solvers import solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    b = np.where(wet, 1.0, 0.0)
    _, res = solve_shifted_chunked(
        ops.T, b, topo, shift=1e-9, tol=1e-15, maxiter=6, chunk=4
    )
    assert float(res) > 0.0  # did not magically converge in 6 iterations


def test_solve_shifted_chunked_stagnation_stop(ops, gridmetrics, indices):
    """When the Krylov recurrence stops making progress the chunked
    solver detects it (a 3-chunk window whose CUMULATIVE norm
    improvement is under 2%) and stops with a warning instead of
    burning to maxiter — a floored 0.25-degree solve would otherwise
    waste its whole iteration budget. Trigger: a skew-dominant
    operator (purely imaginary eigenvalue pairs), the classic BiCGStab
    staller (omega breakdown)."""
    from otmb_tpu.models.solvers import solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d).astype(np.float32)
    z = jnp.zeros_like(ops.T.diag, dtype=jnp.float32)
    w = jnp.asarray(wet)
    skew = ops.T._replace(
        diag=z + 1e-6 * w, east=z + w, west=z - w, north=z, south=z,
        top=z, bottom=z,
    )
    rng = np.random.default_rng(5)
    b = (wet * rng.standard_normal(wet.shape)).astype(np.float32)
    with pytest.warns(UserWarning, match="improved <2%"):
        _, res = solve_shifted_chunked(
            skew, b, topo, shift=np.float32(0.0), tol=1e-300,
            maxiter=100_000, chunk=10, preconditioner="jacobi",
        )
    # bailed long before maxiter, with the honest (recomputed) residual
    assert 0.0 < float(res) < 1.0


def test_ir_defect_promotes_in_jit(ops, gridmetrics, indices):
    """solve_shifted_ir evaluates its defect from the NARROW coefficient
    fields promoted inside the jit (no persistent wide copies); the
    refined result must still reach f64-level residuals OF THE SYSTEM IT
    SOLVES (the f32-rounded operator), checked independently via the
    scipy export of those same f32 coefficients."""
    from otmb_tpu.models.solvers import solve_shifted_ir
    from otmb_tpu.utils.sparse_export import coeffs_to_scipy

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(31)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)

    c32 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), ops.T
    )
    x, rel = solve_shifted_ir(
        c32, b.astype(np.float32), topo, shift=1e-4,
        tol=1e-9, inner_tol=1e-4,
    )
    assert x.dtype == jnp.float64  # wide accumulation
    assert float(rel) < 1e-9

    # independent f64 residual of the f32-rounded operator, against the
    # f32-rounded b the solver actually saw
    a32 = coeffs_to_scipy(c32, indices, topo).astype(np.float64)
    xv = np.asarray(x)[wet]
    bv = b[wet].astype(np.float32).astype(np.float64)
    r = bv - (a32 @ xv + 1e-4 * xv)
    assert np.linalg.norm(r) / np.linalg.norm(bv) < 1e-8


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tridiag_pallas_matches_jnp_scan(ops, gridmetrics, indices, dtype):
    """The Thomas kernel (both sweeps in one program, interpreted here)
    reproduces the jnp scan preconditioner on the real operator's
    vertical part, including land columns (guarded unit diagonal)."""
    from otmb_tpu.models.solvers import _tridiag_preconditioner
    from otmb_tpu.ops.tridiag_pallas import tridiag_solve

    wet = np.asarray(indices.wet3d)
    c = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), ops.T)
    shifted = c.diag + dtype(1e-5)
    rng = np.random.default_rng(41)
    b = np.where(wet, rng.standard_normal(wet.shape), 0.0).astype(dtype)

    ref = _tridiag_preconditioner(c, shifted)(jnp.asarray(b))
    guarded = jnp.where(shifted != 0, shifted, jnp.ones((), dtype))
    out = tridiag_solve(c.bottom, guarded, c.top, b, "interpret")
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=tol, atol=tol)


def test_tridiag_pallas_solves_the_system(ops, gridmetrics, indices):
    """Independent correctness: x from the kernel satisfies the
    per-column tridiagonal system (not just parity with the scan)."""
    from otmb_tpu.ops.tridiag_pallas import tridiag_solve

    wet = np.asarray(indices.wet3d)
    nz = wet.shape[0]
    c = ops.T
    shifted = np.asarray(c.diag) + 1e-5
    guarded = np.where(shifted != 0, shifted, 1.0)
    rng = np.random.default_rng(43)
    b = np.where(wet, rng.standard_normal(wet.shape), 0.0)

    x = np.asarray(tridiag_solve(c.bottom, guarded, c.top, b, "interpret"))
    lower = np.asarray(c.bottom)
    upper = np.asarray(c.top)
    xp = np.concatenate([np.zeros_like(x[:1]), x[:-1]], axis=0)  # x[k-1]
    xn = np.concatenate([x[1:], np.zeros_like(x[:1])], axis=0)  # x[k+1]
    resid = upper * xp + guarded * x + lower * xn - b
    assert np.abs(resid).max() < 1e-10


@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_multi_matches_per_rhs(ops, gridmetrics, indices, transpose):
    """The host-chunked BATCHED Krylov (fori_loop chunks of the batched
    matvec + batched Thomas preconditioner — the 0.25-degree path of
    water_mass_fractions) matches per-RHS chunked solves."""
    from otmb_tpu.models.solvers import (
        solve_shifted_chunked,
        solve_shifted_chunked_multi,
    )

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(17)
    B = 3
    bs = np.stack([
        np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
        for _ in range(B)
    ]).astype(np.float64)

    xs, res = solve_shifted_chunked_multi(
        ops.T, bs, topo, shift=1e-4, tol=1e-12, chunk=7,
        transpose=transpose,
    )
    assert res.shape == (B,)
    assert float(np.max(np.asarray(res))) < 1e-10
    for b in range(B):
        x1, r1 = solve_shifted_chunked(
            ops.T, bs[b], topo, shift=1e-4, tol=1e-12, chunk=7,
            transpose=transpose,
        )
        assert float(r1) < 1e-10
        np.testing.assert_allclose(
            np.asarray(xs[b]), np.asarray(x1), rtol=1e-6, atol=1e-8
        )


def test_chunked_multi_interpreted_kernels(ops, gridmetrics, indices):
    """Same parity with the batched stencil and Thomas kernels running in
    the Pallas interpreter (the kernels the 0.25-degree engine runs on
    the GPU) against per-RHS solves on the plain path."""
    from otmb_tpu.models.solvers import (
        solve_shifted_chunked,
        solve_shifted_chunked_multi,
    )

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(23)
    B = 2
    bs = np.stack([
        np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
        for _ in range(B)
    ]).astype(np.float64)

    xs, res = solve_shifted_chunked_multi(
        ops.T, bs, topo, shift=1e-4, tol=1e-10, chunk=10, interpret=True,
    )
    assert float(np.max(np.asarray(res))) < 1e-8
    for b in range(B):
        x1, r1 = solve_shifted_chunked(
            ops.T, bs[b], topo, shift=1e-4, tol=1e-10, chunk=10,
        )
        np.testing.assert_allclose(
            np.asarray(xs[b]), np.asarray(x1), rtol=1e-5, atol=1e-8
        )


def test_water_mass_fractions_chunked_route(ops, gridmetrics, indices,
                                            monkeypatch):
    """water_mass_fractions on large grids routes to the chunked batched
    Krylov and still returns a surface-partition family whose fractions
    sum to ~1 in the ventilated interior."""
    from otmb_tpu.models import solvers as solvers_mod

    # Treat this grid as large (see CHUNKED_MIN_COLUMNS).
    monkeypatch.setattr(solvers_mod, "CHUNKED_MIN_COLUMNS", 1)
    called = {}
    orig = solvers_mod.solve_shifted_chunked_multi

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(solvers_mod, "solve_shifted_chunked_multi", spy)

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    ny, nx = wet.shape[1:]
    masks = np.zeros((2, ny, nx), bool)
    masks[0, : ny // 2] = True
    masks[1, ny // 2:] = True

    fr, res = solvers_mod.water_mass_fractions(
        ops.T, wet, topo, masks, tol=1e-8, apply_impl="pallas",
    )
    assert called.get("yes")
    assert float(np.max(np.asarray(res))) < 1e-6
    total = np.asarray(jnp.nansum(fr, axis=0))
    interior = np.asarray(wet) & (np.abs(np.asarray(fr[0])) >= 0)
    # fractions of a surface partition sum to ~1 on wet cells
    assert np.nanmax(np.abs(total[np.asarray(wet)] - 1.0)) < 1e-3


def test_ir_bf16_narrow_coefficients(ops, gridmetrics, indices):
    """bf16-narrow iterative refinement: bf16 COEFFICIENT streams (half
    the matvec traffic), f32 Krylov vectors, f64 defect correction. The
    refined residual must reach far below both the bf16 (~1e-2) and f32
    (~1e-4) floors against its own (promoted bf16) operator, and the age
    field must agree with the f32-narrow refined solve to the bf16
    coefficient-rounding level."""
    from otmb_tpu.models.solvers import solve_shifted_ir

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)

    c16 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), ops.T
    )
    x16, res16 = solve_shifted_ir(
        c16, ones, topo, extra_diag=surf, tol=1e-9, max_refinements=25,
    )
    assert float(res16) < 1e-9  # vs the promoted bf16 operator

    # inner Krylov state must be f32, not bf16 (the recurrence would
    # floor near 1e-2 otherwise) — verified by convergence above, and
    # structurally: the returned iterate is wide
    assert x16.dtype == jnp.float64

    c32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), ops.T)
    x32, res32 = solve_shifted_ir(
        c32, ones, topo, extra_diag=surf, tol=1e-9,
    )
    assert float(res32) < 1e-9
    # the two SYSTEMS differ by bf16 coefficient rounding (~4e-3
    # relative); the solutions inherit that scale of difference
    a16, a32 = np.asarray(x16)[wet], np.asarray(x32)[wet]
    denom = np.abs(a32).max()
    assert np.abs(a16 - a32).max() / denom < 0.05


def test_chunked_solver_bf16_coefficients(ops, gridmetrics, indices):
    """The host-chunked Krylov accepts bf16 coefficient streams with f32
    Krylov state (the bf16-narrow inner engine at blocked scale) and
    converges to the bf16 operator's f32-floor."""
    from otmb_tpu.models.solvers import solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(41)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0).astype(
        np.float32
    )
    c16 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), ops.T
    )
    x, res = solve_shifted_chunked(
        c16, jnp.asarray(b), topo, shift=np.float32(1e-4), tol=1e-6,
        chunk=10,
    )
    assert x.dtype == jnp.float32
    assert float(res) < 1e-5


def test_chunked_best_iterate_on_divergence(ops, gridmetrics, indices):
    """A transiently-diverging BiCGStab recurrence (skew-dominant
    operator, the omega-breakdown staller) must never return an iterate
    worse than x0 = 0: best-iterate tracking returns the best
    chunk-boundary iterate, so the recomputed relative residual stays
    <= 1 even with early_stop disabled and the recurrence blowing up."""
    from otmb_tpu.models.solvers import (
        solve_shifted_chunked,
        solve_shifted_chunked_multi,
    )

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d).astype(np.float32)
    z = jnp.zeros_like(ops.T.diag, dtype=jnp.float32)
    w = jnp.asarray(wet)
    skew = ops.T._replace(
        diag=z + 1e-6 * w, east=z + w, west=z - w, north=z, south=z,
        top=z, bottom=z,
    )
    rng = np.random.default_rng(5)
    b = (wet * rng.standard_normal(wet.shape)).astype(np.float32)
    _, res = solve_shifted_chunked(
        skew, b, topo, shift=np.float32(0.0), tol=1e-300,
        maxiter=300, chunk=10, preconditioner="jacobi", early_stop=False,
    )
    assert 0.0 < float(res) <= 1.0 + 1e-5

    bs = np.stack([b, (wet * rng.standard_normal(wet.shape)).astype(
        np.float32)])
    _, res_m = solve_shifted_chunked_multi(
        skew, bs, topo, shift=np.float32(0.0), tol=1e-300,
        maxiter=300, chunk=10, preconditioner="jacobi", early_stop=False,
    )
    assert float(np.max(np.asarray(res_m))) <= 1.0 + 1e-5


def test_ir_survives_diverging_inner_solve(ops, gridmetrics, indices,
                                           monkeypatch):
    """A catastrophically-diverged inner Krylov pass (observed once at
    0.25 degree: the correction blew the outer residual up to ~1e3)
    must not poison the refinement: the outer loop reverts to its
    best iterate and still converges to tol."""
    from otmb_tpu.models import solvers as S

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)

    real = S.solve_shifted
    calls = {"n": 0}

    def sabotaged(coeffs, b, topology, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # second inner pass returns garbage
            bad = jnp.where(jnp.asarray(b) != 0, 1e6, 0.0).astype(
                jnp.asarray(b).dtype)
            return bad, jnp.asarray(1e6, jnp.asarray(b).dtype)
        return real(coeffs, b, topology, **kw)

    monkeypatch.setattr(S, "solve_shifted", sabotaged)
    x, rel = S.solve_shifted_ir(
        c32, ones, topo, extra_diag=surf, tol=1e-9, max_refinements=12,
    )
    assert calls["n"] >= 3  # the sabotage actually fired mid-run
    assert float(rel) < 1e-9
    ref, _ = ideal_age(ops.T, indices.wet3d, topo, tol=1e-10)
    np.testing.assert_allclose(
        np.asarray(x)[wet], np.asarray(ref)[wet], rtol=1e-3, atol=1.0
    )


@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_bicgstab2_matches_bicgstab(ops, gridmetrics, indices,
                                            transpose):
    """BiCGStab(2) in the chunked engine (right-preconditioned in
    y-space, 2D minimal-residual polish per cycle) solves the same
    system to the same tolerance and solution as BiCGStab(1)."""
    from otmb_tpu.models.solvers import solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(53)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)

    x1, r1 = solve_shifted_chunked(
        ops.T, b, topo, shift=1e-4, tol=1e-12, chunk=8,
        transpose=transpose,
    )
    x2, r2 = solve_shifted_chunked(
        ops.T, b, topo, shift=1e-4, tol=1e-12, chunk=8,
        transpose=transpose, algorithm="bicgstab2",
    )
    assert float(r1) < 1e-10 and float(r2) < 1e-10
    np.testing.assert_allclose(
        np.asarray(x2), np.asarray(x1), rtol=1e-6, atol=1e-9
    )


def test_bicgstab2_beats_bicgstab_on_skew_system(ops, gridmetrics, indices):
    """The skew-dominant operator (purely imaginary eigenvalue pairs) is
    BiCGStab(1)'s classic failure mode — it stalls far from convergence
    — while BiCGStab(2)'s two-dimensional MR polish handles conjugate
    pairs. Pin the qualitative gap within an equal matvec budget."""
    from otmb_tpu.models.solvers import solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d).astype(np.float64)
    z = jnp.zeros_like(ops.T.diag)
    w = jnp.asarray(wet)
    skew = ops.T._replace(
        diag=z + 1e-2 * w, east=z + w, west=z - w, north=z, south=z,
        top=z, bottom=z,
    )
    rng = np.random.default_rng(5)
    b = wet * rng.standard_normal(wet.shape)

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, res1 = solve_shifted_chunked(
            skew, b, topo, tol=1e-10, maxiter=400, chunk=20,
            preconditioner="jacobi", early_stop=False, max_restarts=0,
        )
        _, res2 = solve_shifted_chunked(
            skew, b, topo, tol=1e-10, maxiter=400, chunk=20,
            preconditioner="jacobi", early_stop=False, max_restarts=0,
            algorithm="bicgstab2",
        )
    # BiCGStab(2) must converge this system; BiCGStab(1) must not get
    # anywhere near (it historically stalls around O(1))
    assert float(res2) < 1e-6
    assert float(res2) < 1e-3 * float(res1)


@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_multi_bicgstab2_matches(ops, gridmetrics, indices,
                                         transpose):
    """Batched BiCGStab(2) (lockstep per-member cycles in y-space)
    matches the batched BiCGStab(1) solutions."""
    from otmb_tpu.models.solvers import solve_shifted_chunked_multi

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(61)
    bs = np.stack([
        np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0)
        for _ in range(2)
    ])
    x1, r1 = solve_shifted_chunked_multi(
        ops.T, bs, topo, shift=1e-4, tol=1e-12, chunk=8,
        transpose=transpose,
    )
    x2, r2 = solve_shifted_chunked_multi(
        ops.T, bs, topo, shift=1e-4, tol=1e-12, chunk=8,
        transpose=transpose, algorithm="bicgstab2",
    )
    assert float(np.max(np.asarray(r1))) < 1e-10
    assert float(np.max(np.asarray(r2))) < 1e-10
    np.testing.assert_allclose(
        np.asarray(x2), np.asarray(x1), rtol=1e-6, atol=1e-9
    )


def test_chunked_multi_bicgstab2_skew(ops, gridmetrics, indices):
    """Per-member BiCGStab(2) converges the skew-dominant system that
    stalls BiCGStab(1), for every batch member at once."""
    from otmb_tpu.models.solvers import solve_shifted_chunked_multi

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d).astype(np.float64)
    z = jnp.zeros_like(ops.T.diag)
    w = jnp.asarray(wet)
    skew = ops.T._replace(
        diag=z + 1e-2 * w, east=z + w, west=z - w, north=z, south=z,
        top=z, bottom=z,
    )
    rng = np.random.default_rng(6)
    bs = np.stack([wet * rng.standard_normal(wet.shape) for _ in range(2)])

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, res = solve_shifted_chunked_multi(
            skew, bs, topo, tol=1e-10, maxiter=400, chunk=20,
            preconditioner="jacobi", early_stop=False, max_restarts=0,
            algorithm="bicgstab2",
        )
    assert float(np.max(np.asarray(res))) < 1e-6


def test_ir_chunked_inner_path(ops, gridmetrics, indices, monkeypatch):
    """CI coverage of the 0.25-degree refinement path: solve_shifted_ir
    routed through the host-chunked inner engine (the default
    BiCGStab(2) cycles), which `_use_chunked` only selects on large
    grids — forced here so CPU tests run the same composition."""
    from otmb_tpu.models import solvers as S

    monkeypatch.setattr(S, "_use_chunked", lambda *a, **k: True)

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)

    x, rel = S.solve_shifted_ir(
        c32, ones, topo, extra_diag=surf, tol=1e-9, apply_impl="pallas",
    )
    assert float(rel) < 1e-9
    ref, _ = ideal_age(ops.T, indices.wet3d, topo, tol=1e-10)
    np.testing.assert_allclose(
        np.asarray(x)[wet], np.asarray(ref)[wet], rtol=1e-3, atol=1.0
    )

    # and the bicgstab(1) inner variant of the same path
    x1, rel1 = S.solve_shifted_ir(
        c32, ones, topo, extra_diag=surf, tol=1e-9, apply_impl="pallas",
        inner_algorithm="bicgstab",
    )
    assert float(rel1) < 1e-9


def _skew_case(ops, gridmetrics, indices, seed=5):
    wet = np.asarray(indices.wet3d).astype(np.float32)
    z = jnp.zeros_like(ops.T.diag, dtype=jnp.float32)
    w = jnp.asarray(wet)
    skew = ops.T._replace(
        diag=z + 1e-6 * w, east=z + w, west=z - w, north=z, south=z,
        top=z, bottom=z,
    )
    rng = np.random.default_rng(seed)
    b = (wet * rng.standard_normal(wet.shape)).astype(np.float32)
    return skew, b, wet


def test_chunked_divergence_exit_stops_early(ops, gridmetrics, indices):
    """In-pass divergence exit (round-4 verdict #3): a chunk sequence
    whose recurrence residual climbs above 4x its pass-start value must
    abort instead of burning the whole budget (with max_restarts=0, the
    IR inner-solve configuration)."""
    from otmb_tpu.models.solvers import solve_shifted_chunked

    skew, b, _ = _skew_case(ops, gridmetrics, indices)
    topo = gridmetrics.topology
    stats = {}
    _, res = solve_shifted_chunked(
        skew, b, topo, shift=np.float32(0.0), tol=1e-300,
        maxiter=3000, chunk=10, preconditioner="jacobi",
        max_restarts=0, stats=stats,
    )
    assert stats["stop"] in ("diverged", "stall")
    # the skew recurrence blows past 4x within a few chunks; the exit
    # must fire long before the 3000-iteration budget
    assert stats["iters"] < 1000
    assert 0.0 < float(res) <= 1.0 + 1e-5  # best iterate still protects
    assert stats["end_rel"] <= 1.0 + 1e-5


def test_chunked_stats_on_convergence(ops, gridmetrics, indices):
    from otmb_tpu.models.solvers import solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(11)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0).astype(
        np.float32)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    stats = {}
    x, res = solve_shifted_chunked(
        c32, b, topo, shift=np.float32(1e-3), tol=1e-5, chunk=25,
        stats=stats,
    )
    assert stats["stop"] == "converged"
    assert 0 < stats["iters"] <= 2000
    assert stats["restarts"] == 0
    assert stats["end_rel"] <= 1e-5 * 1.5
    assert float(res) < 1e-4


def test_chunked_multi_per_member_restart_and_stats(ops, gridmetrics,
                                                    indices):
    """Batched engine: a diverging member triggers a PER-MEMBER restart
    (advisor round 4: converged/improving members must not suppress or
    be disturbed by a stalled member's restart). Pair a well-conditioned
    RHS with a skew-dominated one via a member-dependent operator is not
    possible (shared operator), so instead check that with a skew
    operator both members exit early with stats populated and protected
    residuals."""
    from otmb_tpu.models.solvers import solve_shifted_chunked_multi

    skew, b, wet = _skew_case(ops, gridmetrics, indices)
    topo = gridmetrics.topology
    rng = np.random.default_rng(7)
    bs = np.stack([b, (wet * rng.standard_normal(wet.shape)).astype(
        np.float32)])
    stats = {}
    _, res = solve_shifted_chunked_multi(
        skew, bs, topo, shift=np.float32(0.0), tol=1e-300,
        maxiter=3000, chunk=10, preconditioner="jacobi",
        max_restarts=1, stats=stats,
    )
    assert stats["stop"] in ("diverged", "stall")
    assert stats["iters"] < 1500
    assert stats["restarts"] >= 1
    assert float(np.max(np.asarray(res))) <= 1.0 + 1e-5


def test_ir_stats_per_pass(ops, gridmetrics, indices):
    """solve_shifted_ir reports per-pass diagnostics (round-4 verdict
    weak #7: slow solves were undiagnosable from artifacts alone)."""
    from otmb_tpu.models.solvers import solve_shifted_ir

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    stats = {}
    x, rel = solve_shifted_ir(
        c32, ones, topo, extra_diag=surf, tol=1e-9, stats=stats,
    )
    assert float(rel) < 1e-9
    assert stats["refinements"] == len(stats["passes"]) >= 1
    assert stats["rel_final"] == float(rel)
    p0 = stats["passes"][0]
    assert p0["rel_start"] == 1.0  # defect of x0 = 0 is b
    assert p0["reverted"] is False
    rels = [p["rel_start"] for p in stats["passes"]]
    assert rels == sorted(rels, reverse=True)  # monotone contraction


def test_use_chunked_size_rule(ops, gridmetrics, indices, monkeypatch):
    """The engine choice is a size rule on the grid (CHUNKED_MIN_COLUMNS):
    the 0.25-degree plane takes the chunked BiCGStab(2) engine, the
    1-degree plane the while_loop solver, and ideal_age follows it."""
    from otmb_tpu.grid.topology import GridTopology
    from otmb_tpu.models import solvers as S

    quarter = GridTopology(kind="tripolar", nx=1440, ny=1080, nz=75)
    one = GridTopology(kind="tripolar", nx=360, ny=300, nz=50)
    assert S._use_chunked("pallas", None, False, quarter)
    assert not S._use_chunked("pallas", None, False, one)
    assert not S._use_chunked("jnp", None, False, quarter)
    assert not S._use_chunked("pallas", None, True, quarter)

    topo = gridmetrics.topology
    called = {}
    real = S.solve_shifted_chunked

    def spy(*a, **k):
        called["algorithm"] = k.get("algorithm")
        return real(*a, **k)

    monkeypatch.setattr(S, "solve_shifted_chunked", spy)
    S.ideal_age(ops.T, indices.wet3d, topo, tol=1e-8, apply_impl="pallas")
    assert not called
    monkeypatch.setattr(S, "CHUNKED_MIN_COLUMNS", 1)
    _, res = S.ideal_age(ops.T, indices.wet3d, topo, tol=1e-8,
                         apply_impl="pallas")
    assert called["algorithm"] == "bicgstab2"
    assert float(res) < 1e-7


@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_bicgstab2_interpreted_thomas(ops, gridmetrics, indices,
                                              transpose):
    """The chunked BiCGStab(2) engine with the Thomas kernel in the
    Pallas interpreter reaches the same solution as with the plain scans
    (forward and adjoint)."""
    from otmb_tpu.models.solvers import solve_shifted_chunked

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    rng = np.random.default_rng(77)
    b = np.where(wet, rng.standard_normal(gridmetrics.shape), 0.0).astype(
        np.float32)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    kw = dict(shift=np.float32(1e-3), tol=1e-6, chunk=20,
              algorithm="bicgstab2", transpose=transpose)
    xk, rk = solve_shifted_chunked(c32, b, topo, interpret=True, **kw)
    xc, rc = solve_shifted_chunked(c32, b, topo, **kw)
    assert float(rk) < 1e-5 and float(rc) < 1e-5
    scale = float(np.abs(np.asarray(xc)).max())
    np.testing.assert_allclose(np.asarray(xk), np.asarray(xc),
                               atol=2e-4 * scale, rtol=0)


def test_solve_shifted_rejects_unknown_apply_impl(ops, gridmetrics):
    from otmb_tpu.models.solvers import solve_shifted

    b = np.ones(gridmetrics.shape)
    with pytest.raises(ValueError, match="apply_impl"):
        solve_shifted(ops.T, b, gridmetrics.topology, apply_impl="cuda")
    with pytest.raises(ValueError, match="bicgstab"):
        solve_shifted(ops.T, b, gridmetrics.topology, method="gmres",
                      apply_impl="pallas")


def test_diverge_restarts_break_deterministic_blowup(ops, gridmetrics,
                                                     indices):
    """The determinism trap (round-5 bench, seed-1 circulation): a
    diverged pass whose best iterate is x0 must NOT replay the identical
    blow-up — divergence restarts perturb the shadow vector and get
    their own budget even when max_restarts=0 (the refinement inner
    configuration). The raw f32 age system on this grid NaNs
    BiCGStab(1) within the first chunk, which fires exactly this
    branch."""
    from otmb_tpu.grid.geometry import makegridmetrics
    from otmb_tpu.grid.indices import makeindices
    from otmb_tpu.models.solvers import solve_shifted_chunked
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.utils.synthetic import synthetic_dataset

    ds = synthetic_dataset(nx=24, ny=16, nz=8, topology="tripolar",
                           seed=42)
    gridmetrics = makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
        lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
        lat_vertices=ds.lat_vertices,
    )
    indices = makeindices(gridmetrics.v3d)
    phi = facefluxesfrommasstransport(
        umo=ds.umo, vmo=ds.vmo, gridmetrics=gridmetrics, indices=indices,
    )
    ops = transportmatrix(
        phi=phi, mlotst=ds.mlotst, gridmetrics=gridmetrics,
        indices=indices,
    )
    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)
    ones = np.where(wet, np.float32(1.0), np.float32(0.0))
    surf = np.zeros(gridmetrics.shape, np.float32)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0).astype(np.float32)
    stats = {}
    _, res = solve_shifted_chunked(
        c32, ones, topo, extra_diag=surf, tol=1e-6,
        algorithm="bicgstab", max_restarts=0, max_diverge_restarts=2,
        stats=stats,
    )
    assert stats["diverge_restarts"] >= 1  # the jittered retries fired
    assert float(res) <= 1.0 + 1e-5
    # with the budget off, the exit is immediate (old behavior)
    st0 = {}
    solve_shifted_chunked(
        c32, ones, topo, extra_diag=surf, tol=1e-6,
        algorithm="bicgstab", max_restarts=0, max_diverge_restarts=0,
        stats=st0,
    )
    assert st0["diverge_restarts"] == 0
    assert st0["iters"] <= stats["iters"]


def test_ir_dynamic_pass_tolerance(ops, gridmetrics, indices, monkeypatch):
    """Late refinement passes must run with a WIDENED inner tolerance:
    once the outer defect sits at relf, contracting the defect system
    past ~0.5*tol/relf is wasted work (the 0.25-degree driver log showed
    a final pass burning its full 600-iteration budget where a 3x
    contraction sufficed). Each pass's effective tolerance is
    max(inner_tol, 0.5*tol/relf), recorded in the pass stats."""
    from otmb_tpu.models import solvers as S

    topo = gridmetrics.topology
    wet = np.asarray(indices.wet3d)
    ones = np.where(wet, 1.0, 0.0)
    surf = np.zeros(gridmetrics.shape)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), ops.T)

    real = S.solve_shifted
    seen_tols = []

    def recording(coeffs, b, topology, **kw):
        seen_tols.append(kw.get("tol"))
        return real(coeffs, b, topology, **kw)

    monkeypatch.setattr(S, "solve_shifted", recording)
    stats = {}
    tol = 1e-9
    x, rel = S.solve_shifted_ir(
        c32, ones, topo, extra_diag=surf, tol=tol, inner_tol=1e-4,
        stats=stats,
    )
    assert float(rel) < tol
    passes = stats["passes"]
    assert len(passes) == len(seen_tols) >= 2
    for p, t in zip(passes, seen_tols):
        expect = min(0.9, max(1e-4, 0.5 * tol / p["rel_start"]))
        assert t == pytest.approx(expect)
        assert p["inner_tol"] == pytest.approx(expect)
    # a synthetic near-converged pass widens: at rel_start 2e-9 the
    # formula hands the inner solve a 0.25 tolerance, not inner_tol
    assert min(0.9, max(1e-4, 0.5 * tol / 2e-9)) == pytest.approx(0.25)


def test_multi_diverge_restarts_jittered(ops, gridmetrics, indices):
    """Batched analogue of the deterministic-blow-up trap: a diverged
    member in the chunked multi engine gets jittered divergence
    restarts from its OWN budget even when max_restarts=0 (the
    refinement/fixed-iteration configuration), and non-diverging
    members pass through the restart untouched. Same raw f32 age
    system that NaNs BiCGStab(1) in its first chunk, batched with a
    benign all-ones member."""
    from otmb_tpu.grid.geometry import makegridmetrics
    from otmb_tpu.grid.indices import makeindices
    from otmb_tpu.models.solvers import solve_shifted_chunked_multi
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.utils.synthetic import synthetic_dataset

    ds = synthetic_dataset(nx=24, ny=16, nz=8, topology="tripolar",
                           seed=42)
    gm = makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
        lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
        lat_vertices=ds.lat_vertices,
    )
    idx = makeindices(gm.v3d)
    phi = facefluxesfrommasstransport(
        umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx,
    )
    tops = transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm,
                           indices=idx)
    topo = gm.topology
    wet = np.asarray(idx.wet3d)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tops.T)
    ones = np.where(wet, np.float32(1.0), np.float32(0.0))
    surf = np.zeros(gm.shape, np.float32)
    surf[0] = 1.0
    surf = np.where(wet, surf, 0.0).astype(np.float32)
    bs = np.stack([ones, 0.5 * ones])
    stats = {}
    _, res = solve_shifted_chunked_multi(
        c32, bs, topo, extra_diag=surf, tol=1e-6,
        algorithm="bicgstab", max_restarts=0, max_diverge_restarts=2,
        stats=stats,
    )
    assert stats["diverge_restarts"] >= 1  # the jittered retries fired
    # best-iterate protection: no member returns worse than x0
    assert np.asarray(res).max() <= 1.0 + 1e-5
    # with the budget off, the exit is immediate (old behavior)
    st0 = {}
    solve_shifted_chunked_multi(
        c32, bs, topo, extra_diag=surf, tol=1e-6,
        algorithm="bicgstab", max_restarts=0, max_diverge_restarts=0,
        stats=st0,
    )
    assert st0["diverge_restarts"] == 0
    assert st0["iters"] <= stats["iters"]


@pytest.mark.chip
@pytest.mark.parametrize("engine", ["while_loop", "bicgstab2", "batched"])
def test_krylov_dots_compile_as_reductions(gpu, engine):
    """The Krylov inner products are f32 `vdot`s / sums over whole grid
    vectors. On the GPU XLA must compile them as reductions: a cuBLAS or
    Triton GEMM may run f32 in TF32 (about three digits), on which the
    recurrences cannot converge to 1e-9. Checked on each engine's
    compiled program."""
    import re

    from otmb_tpu.models.solvers import _mr_chunk2, _sr_chunk2, solve_shifted
    from otmb_tpu.models.transport import assemble_transport
    from otmb_tpu.utils.synthetic import synthetic_device_case

    gm, wet, umo, vmo, mlotst = synthetic_device_case(128, 96, 20, seed=0)
    T = assemble_transport(umo, vmo, mlotst, gm, wet).T
    topo = gm.topology
    b = jnp.where(wet, 1.0, 0.0).astype(jnp.float32)
    one, zero = jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)
    if engine == "while_loop":
        lowered = solve_shifted.lower(T, b, topo, tol=1e-6,
                                      apply_impl="pallas")
    elif engine == "bicgstab2":
        state = (0 * b, b, 0 * b, b, one, zero, one)
        lowered = _sr_chunk2.lower(T, T, T.diag, state, 2, topo, "tridiag",
                                   "gpu")
    else:
        bs = jnp.stack([b, 2 * b, 3 * b])
        ones = jnp.ones((3,), jnp.float32)
        state = (0 * bs, bs, 0 * bs, bs, ones, 0 * ones, ones)
        lowered = _mr_chunk2.lower(T, T, T.diag, state, 2, topo, "tridiag",
                                   "gpu")
    # metadata carries source names, which may say anything
    hlo = re.sub(r"metadata=\{[^}]*\}", "", lowered.compile().as_text())
    gemms = sorted(set(re.findall(r"[\w$.]*(?:cublas|gemm)[\w$.]*", hlo,
                                  re.IGNORECASE)))
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    assert gemms == [], (gemms, targets)
    assert "otmb_thomas" in hlo  # the kernel route was compiled
