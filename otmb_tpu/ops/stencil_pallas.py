"""Batched 7-point stencil: one Pallas kernel for the GPU (Triton route)
that applies the same operator to B tracers.

Real transport workloads push MANY tracers through the SAME operator
(water-mass fractions, dye releases, tracer ensembles). XLA's fusion of
`ops.apply.apply_stencil` over a (B, nz, ny, nx) batch reads each
coefficient once per tracer: the coefficients' reuse distance is one
tracer volume, and the seven coefficient fields (151 MB at 1 degree,
3.3 GB at 0.25 degree, f32) do not fit in the card's L2. Here each
program loads its tile of the seven coefficient fields once and loops
over the batch, so per-tracer traffic is 2 + 7/B streams instead of 9.

Each program owns one k level and a run of `_TILE` consecutive cells of
the flattened (ny, nx) plane. Neighbours come in by index arithmetic on
the flat plane: the periodic i wrap, the j = 0 and k ends (zero fill),
and the tripolar fold of the top row, (ny-1, i) -> (ny-1, nx-1-i). The
sum is taken in `apply_stencil`'s order (diag, east, west, north, south,
top, bottom), so interpret mode agrees with it bitwise.

No reference counterpart (the reference applies its sparse matrix to one
vector at a time).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..grid.topology import GridTopology
from .apply import apply_stencil
from .coeffs import StencilCoeffs
from .pallas_util import check_route, int32_batches, kernel_route

#: Cells of one k level per program, and warps per program.
_TILE = 512
_WARPS = 4


def _stencil_kernel(d_ref, e_ref, w_ref, n_ref, s_ref, t_ref, b_ref, chi_ref,
                    dt_ref, out_ref, *, nb: int, nz: int, ny: int, nx: int,
                    tripolar: bool, euler: bool):
    plane = ny * nx
    k = pl.program_id(1)
    p = pl.program_id(0) * _TILE + jnp.arange(_TILE, dtype=jnp.int32)
    # Lanes past the plane stay masked, never clamped: a masked store
    # with duplicate indices is undefined in interpret mode.
    live = p < plane
    j = p // nx
    i = p - j * nx
    east = jnp.where(i == nx - 1, p - (nx - 1), p + 1)
    west = jnp.where(i == 0, p + (nx - 1), p - 1)
    top_row = j == ny - 1
    north = jnp.where(top_row, (ny - 1) * nx + (nx - 1 - i), p + nx)
    north_ok = live if tripolar else live & ~top_row
    south_ok = live & (j > 0)
    south = jnp.where(south_ok, p - nx, 0)
    up_ok = live & (k > 0)
    down_ok = live & (k < nz - 1)

    dtype = out_ref.dtype
    coef = lambda ref: plgpu.load(
        ref.at[k * plane + p], mask=live, other=0.0).astype(dtype)
    cd, ce, cw = coef(d_ref), coef(e_ref), coef(w_ref)
    cn, cs, ct, cb = coef(n_ref), coef(s_ref), coef(t_ref), coef(b_ref)
    # dt is a one-element input (it may be traced); every lane loads it.
    dt = plgpu.load(dt_ref.at[jnp.zeros((_TILE,), jnp.int32)])

    def tracer(m, carry):
        base = (m * nz + k) * plane
        val = lambda idx, ok: plgpu.load(chi_ref.at[base + idx], mask=ok,
                                         other=0.0)
        x = val(p, live)
        acc = cd * x
        acc = acc + ce * val(east, live)
        acc = acc + cw * val(west, live)
        acc = acc + cn * val(north, north_ok)
        acc = acc + cs * val(south, south_ok)
        acc = acc + ct * val(jnp.where(up_ok, p - plane, p), up_ok)
        acc = acc + cb * val(jnp.where(down_ok, p + plane, p), down_ok)
        if euler:
            acc = x - dt * acc
        plgpu.store(out_ref.at[base + p], acc, mask=live)
        return carry

    jax.lax.fori_loop(jnp.int32(0), jnp.int32(nb), tracer, jnp.int32(0))


def _stencil_pallas(coeffs: StencilCoeffs, chis, dt, topology: GridTopology,
                    euler: bool, interpret: bool):
    """The kernel over the batch, in as many calls as int32 indexing
    needs (`pallas_util.int32_batches`)."""
    nb, nz, ny, nx = chis.shape
    slices = int32_batches(nb, nz * ny * nx, _TILE)
    if len(slices) == 1:
        return _stencil_call(coeffs, chis, dt, topology, euler, interpret)
    return jnp.concatenate([
        _stencil_call(coeffs, chis[a:b], dt, topology, euler, interpret)
        for a, b in slices
    ])


@functools.partial(jax.jit, static_argnames=("topology", "euler", "interpret"))
def _stencil_call(coeffs: StencilCoeffs, chis, dt, topology: GridTopology,
                  euler: bool, interpret: bool):
    nb, nz, ny, nx = chis.shape
    kernel = functools.partial(
        _stencil_kernel, nb=nb, nz=nz, ny=ny, nx=nx,
        tripolar=topology.is_tripolar, euler=euler,
    )
    flat = lambda a: jnp.asarray(a).reshape(-1)
    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(ny * nx, _TILE), nz),
        out_shape=jax.ShapeDtypeStruct((chis.size,), chis.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS, num_stages=1),
        interpret=interpret,
        name="otmb_stencil_multi",
    )(flat(coeffs.diag), flat(coeffs.east), flat(coeffs.west),
      flat(coeffs.north), flat(coeffs.south), flat(coeffs.top),
      flat(coeffs.bottom), flat(chis), jnp.asarray(dt, chis.dtype).reshape(1))
    return out.reshape(chis.shape)


def _check_batch(chis, topology: GridTopology):
    chis = jnp.asarray(chis)
    if chis.ndim != 4 or chis.shape[1:] != topology.shape3d:
        raise ValueError(
            f"chis must be (B, {', '.join(map(str, topology.shape3d))}); "
            f"got {chis.shape}"
        )
    return chis


def apply_stencil_pallas_multi(coeffs: StencilCoeffs, chis,
                               topology: GridTopology,
                               route: str | None = None):
    """y[b] = T @ chis[b] for a batch (B, nz, ny, nx) of tracers.

    `route` (default: `kernel_route()`): ``"gpu"`` runs the compiled
    kernel, ``"interpret"`` the same kernel in the Pallas interpreter,
    ``"jnp"`` the plain `apply_stencil` broadcast over the batch."""
    chis = _check_batch(chis, topology)
    route = check_route(route or kernel_route())
    if route == "jnp":
        return apply_stencil(coeffs, chis, topology)
    return _stencil_pallas(coeffs, chis, 0.0, topology, euler=False,
                           interpret=route == "interpret")


def euler_step_pallas_multi(coeffs: StencilCoeffs, chis, dt,
                            topology: GridTopology, route: str | None = None):
    """chis - dt * T @ chis for a batch of tracers in one pass (see
    `apply_stencil_pallas_multi` for `route`); `dt` is a scalar, traced or
    not."""
    chis = _check_batch(chis, topology)
    route = check_route(route or kernel_route())
    if route == "jnp":
        return chis - dt * apply_stencil(coeffs, chis, topology)
    return _stencil_pallas(coeffs, chis, dt, topology, euler=True,
                           interpret=route == "interpret")
