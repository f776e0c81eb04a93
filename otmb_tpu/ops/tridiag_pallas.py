"""Per-column tridiagonal (Thomas) solves: the plain scan and a Pallas
kernel for the GPU (Triton route).

The vertical-line preconditioner of the Krylov solvers
(`models/solvers.py:_tridiag_preconditioner`) solves, independently for
every water column (j, i):

    upper[k] * x[k-1] + diag[k] * x[k] + lower[k] * x[k+1] = b[k]

`tridiag_solve_ref` is two `lax.scan`s over k. On the GPU each scan step
is a small kernel over one (ny, nx) level, so one solve is a loop of
about 2 * nz launches whose cp/dp intermediates go through device
memory. The kernel gives each program a tile of independent columns and
runs both sweeps inside it, with cp/dp held in registers (the k loops
are unrolled at trace time), so device traffic is the floor of five
streams: lower, diag, upper and b in, x out.

The kernel keeps the scan's operation order (cp = lower / denom by
division, dp scaled by a reciprocal multiply, the denom != 0 guard), so
the two agree to a few ulps; in interpret mode they agree bitwise.

No reference counterpart: the reference solves its assembled sparse
matrix with a direct factorization (test/local_full.jl:165-168); the
vertical-line preconditioner is part of this framework's matrix-free
solver architecture.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .pallas_util import check_route, int32_batches

#: Columns per program: one per thread of four warps, so the 2 * nz
#: values of cp/dp fit each thread's registers at f32 and nz <= 75.
_COLUMNS = 128
_WARPS = 4


def tridiag_solve_ref(lower, diag, upper, b):
    """Plain Thomas solve over axis 0 of (nz, ny, nx) fields."""
    one = jnp.ones((), b.dtype)

    def fwd(carry, k):
        cp_prev, dp_prev = carry
        denom = diag[k] - upper[k] * cp_prev
        denom = jnp.where(denom != 0, denom, one)
        cp = lower[k] / denom
        dp = (b[k] - upper[k] * dp_prev) * (one / denom)
        return (cp, dp), (cp, dp)

    nz = b.shape[0]
    zeros = jnp.zeros_like(b[0])
    _, (cps, dps) = jax.lax.scan(fwd, (zeros, zeros), jnp.arange(nz))

    def bwd(x_next, k):
        x = dps[k] - cps[k] * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, zeros, jnp.arange(nz), reverse=True)
    return xs


def _thomas_kernel(lo_ref, di_ref, up_ref, b_ref, x_ref, *, nz: int, n: int):
    col = pl.program_id(0) * _COLUMNS + jnp.arange(_COLUMNS, dtype=jnp.int32)
    # Lanes past the last column stay masked, never clamped: a masked
    # store with duplicate indices is undefined in interpret mode.
    mask = col < n
    base = pl.program_id(1) * (nz * n)
    dtype = x_ref.dtype
    one = jnp.ones((), dtype)

    def load(ref, off, other):
        return plgpu.load(ref.at[off + col], mask=mask, other=other)

    cp_prev = jnp.zeros((_COLUMNS,), dtype)
    dp_prev = jnp.zeros((_COLUMNS,), dtype)
    cps, dps = [], []
    for k in range(nz):
        up = load(up_ref, k * n, 0.0)
        denom = load(di_ref, k * n, 1.0) - up * cp_prev
        denom = jnp.where(denom != 0, denom, one)
        cp = load(lo_ref, k * n, 0.0) / denom
        dp = (load(b_ref, base + k * n, 0.0) - up * dp_prev) * (one / denom)
        cps.append(cp)
        dps.append(dp)
        cp_prev, dp_prev = cp, dp

    x_next = jnp.zeros((_COLUMNS,), dtype)
    for k in range(nz - 1, -1, -1):
        x = dps[k] - cps[k] * x_next
        plgpu.store(x_ref.at[base + k * n + col], x, mask=mask)
        x_next = x


def _tridiag_pallas(lower, diag, upper, bs, interpret: bool):
    """The kernel over the batch, in as many calls as int32 indexing
    needs (`pallas_util.int32_batches`)."""
    nb, nz, ny, nx = bs.shape
    slices = int32_batches(nb, nz * ny * nx, _COLUMNS)
    if len(slices) == 1:
        return _tridiag_call(lower, diag, upper, bs, interpret)
    return jnp.concatenate([
        _tridiag_call(lower, diag, upper, bs[a:b], interpret)
        for a, b in slices
    ])


@functools.partial(jax.jit, static_argnames=("interpret",))
def _tridiag_call(lower, diag, upper, bs, interpret: bool):
    nb, nz, ny, nx = bs.shape
    n = ny * nx
    dtype = bs.dtype
    flat = lambda a: jnp.asarray(a, dtype).reshape(-1)
    out = pl.pallas_call(
        functools.partial(_thomas_kernel, nz=nz, n=n),
        grid=(pl.cdiv(n, _COLUMNS), nb),
        out_shape=jax.ShapeDtypeStruct((nb * nz * n,), dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS, num_stages=1),
        interpret=interpret,
        name="otmb_thomas",
    )(flat(lower), flat(diag), flat(upper), bs.reshape(-1))
    return out.reshape(bs.shape)


def tridiag_solve(lower, diag, upper, b, route: str):
    """Solve the per-column tridiagonal system for every (j, i) column.

    Coefficients are (nz, ny, nx); `b` is (nz, ny, nx) or a batch
    (B, nz, ny, nx) sharing them. `lower` couples to k+1, `upper` to k-1
    (the `coeffs.bottom` / `coeffs.top` convention of StencilCoeffs).
    Land columns must be pre-guarded (diag == 0 replaced by 1), exactly
    as `_tridiag_preconditioner` does. `route` comes from
    `ops.pallas_util.kernel_route`.
    """
    b = jnp.asarray(b)
    if check_route(route) == "jnp":
        if b.ndim == 4:
            return jax.vmap(lambda v: tridiag_solve_ref(lower, diag, upper, v))(b)
        return tridiag_solve_ref(lower, diag, upper, b)
    bs = b if b.ndim == 4 else b[None]
    x = _tridiag_pallas(lower, diag, upper, bs, interpret=route == "interpret")
    return x if b.ndim == 4 else x[0]
