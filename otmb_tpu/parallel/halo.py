"""Explicit halo-exchange stencil application under shard_map.

The GSPMD path (jit over sharded arrays) is correct and automatic; this
module is the hand-scheduled alternative: a 1-cell halo of the tracer
field is exchanged with neighbor shards via `jax.lax.ppermute` over the
('y', 'x') mesh, then the 7-point stencil is applied shard-locally. This
pins the communication pattern (neighbor ppermutes, no
accidental all-gathers) and is the substrate for comm/compute overlap.

Topology handling across shards:
  * x (longitude) is globally periodic -> ppermute with wraparound;
  * y (latitude): no wrap; the south halo of the bottom shard row and the
    north halo of the top shard row (bipolar) are zeros (their stencil
    coefficients are exactly zero there);
  * tripolar seam: the north neighbor of global top row (ny-1, i) is
    (ny-1, nx-1-i) — in shard terms, shard (y_top, x) receives the
    i-reversed local top row of its mirror shard (y_top, nx_dev-1-x),
    exchanged with a dedicated ppermute over 'x'
    (reference semantics: gridtopology.jl:94-95).

Only chi needs halos — the stencil gathers chi at neighbors and weights
it with local coefficients.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..grid.topology import GridTopology
from ..ops.coeffs import StencilCoeffs


def _halo_exchange(chi, topology: GridTopology, mesh: Mesh):
    """Return (east, west, north, south) 1-cell halos of the local chi
    block, each shaped like the corresponding boundary slice.

    Rank-agnostic over leading axes: works on (nz, ny_l, nx_l) fields and
    on batched (B, nz, ny_l, nx_l) tracer stacks (the multi-tracer
    sharded path) — only the trailing (y, x) axes are sliced."""
    ny_dev = mesh.shape["y"]
    nx_dev = mesh.shape["x"]

    # --- x halos (periodic) ---
    if nx_dev > 1:
        right = [(s, (s + 1) % nx_dev) for s in range(nx_dev)]
        left = [(s, (s - 1) % nx_dev) for s in range(nx_dev)]
        # east halo = west-most column of the east neighbor
        east_halo = jax.lax.ppermute(chi[..., :1], "x", left)
        west_halo = jax.lax.ppermute(chi[..., -1:], "x", right)
    else:
        east_halo = chi[..., :1]
        west_halo = chi[..., -1:]

    # --- y halos (no wrap; seam handled separately) ---
    if ny_dev > 1:
        down = [(s, s - 1) for s in range(1, ny_dev)]  # send southward
        up = [(s, s + 1) for s in range(ny_dev - 1)]  # send northward
        north_halo = jax.lax.ppermute(chi[..., :1, :], "y", down)
        south_halo = jax.lax.ppermute(chi[..., -1:, :], "y", up)
    else:
        north_halo = jnp.zeros_like(chi[..., :1, :])
        south_halo = jnp.zeros_like(chi[..., :1, :])

    if topology.is_tripolar:
        # Mirror-shard exchange of the i-reversed local top row. Runs in
        # every y subgroup (one tiny row each) but is only consumed by the
        # top shard row.
        mirror = [(s, nx_dev - 1 - s) for s in range(nx_dev)]
        fold_payload = chi[..., -1:, ::-1]
        fold_halo = (
            jax.lax.ppermute(fold_payload, "x", mirror)
            if nx_dev > 1
            else fold_payload
        )
        my_y = jax.lax.axis_index("y")
        is_top = my_y == ny_dev - 1
        north_halo = jnp.where(is_top, fold_halo, north_halo)

    return east_halo, west_halo, north_halo, south_halo


def _local_stencil(coeffs: StencilCoeffs, chi, halos):
    east_h, west_h, north_h, south_h = halos
    east = jnp.concatenate([chi[:, :, 1:], east_h], axis=2)
    west = jnp.concatenate([west_h, chi[:, :, :-1]], axis=2)
    north = jnp.concatenate([chi[:, 1:, :], north_h], axis=1)
    south = jnp.concatenate([south_h, chi[:, :-1, :]], axis=1)
    up = jnp.concatenate([jnp.zeros_like(chi[:1]), chi[:-1]], axis=0)
    down = jnp.concatenate([chi[1:], jnp.zeros_like(chi[:1])], axis=0)

    return (
        coeffs.diag * chi
        + coeffs.east * east
        + coeffs.west * west
        + coeffs.north * north
        + coeffs.south * south
        + coeffs.top * up
        + coeffs.bottom * down
    )


def _local_stencil_overlapped(coeffs: StencilCoeffs, chi, halos):
    """Same result as `_local_stencil`, structured for comm/compute
    overlap: the bulk of the stencil uses only shard-local data
    (zero-filled shifts), and the halo contributions are added to the
    boundary slices afterwards. Since the bulk has no data dependency on
    the ppermutes, XLA can run the collective-permutes concurrently with
    the interior compute."""
    east_h, west_h, north_h, south_h = halos
    z_col = jnp.zeros_like(chi[:, :, :1])
    z_row = jnp.zeros_like(chi[:, :1, :])

    east0 = jnp.concatenate([chi[:, :, 1:], z_col], axis=2)
    west0 = jnp.concatenate([z_col, chi[:, :, :-1]], axis=2)
    north0 = jnp.concatenate([chi[:, 1:, :], z_row], axis=1)
    south0 = jnp.concatenate([z_row, chi[:, :-1, :]], axis=1)
    up = jnp.concatenate([jnp.zeros_like(chi[:1]), chi[:-1]], axis=0)
    down = jnp.concatenate([chi[1:], jnp.zeros_like(chi[:1])], axis=0)

    bulk = (
        coeffs.diag * chi
        + coeffs.east * east0
        + coeffs.west * west0
        + coeffs.north * north0
        + coeffs.south * south0
        + coeffs.top * up
        + coeffs.bottom * down
    )
    # boundary corrections (halo-dependent, tiny)
    bulk = bulk.at[:, :, -1].add(coeffs.east[:, :, -1] * east_h[:, :, 0])
    bulk = bulk.at[:, :, 0].add(coeffs.west[:, :, 0] * west_h[:, :, 0])
    bulk = bulk.at[:, -1, :].add(coeffs.north[:, -1, :] * north_h[:, 0, :])
    bulk = bulk.at[:, 0, :].add(coeffs.south[:, 0, :] * south_h[:, 0, :])
    return bulk


def apply_stencil_halo(
    coeffs: StencilCoeffs, chi, topology: GridTopology, mesh: Mesh
):
    """y = T @ chi with explicit shard_map halo exchange over `mesh`.

    Matches `ops.apply.apply_stencil` exactly (tested on the virtual CPU
    mesh); use inside jit with sharded inputs.
    """
    spec3 = P(None, "y", "x")

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: spec3, coeffs), spec3),
        out_specs=spec3,
    )
    def _apply(coeffs_local, chi_local):
        halos = _halo_exchange(chi_local, topology, mesh)
        return _local_stencil(coeffs_local, chi_local, halos)

    return _apply(coeffs, jnp.asarray(chi))


def euler_propagate_halo(
    coeffs: StencilCoeffs,
    chi,
    dt,
    nsteps: int,
    topology: GridTopology,
    mesh: Mesh,
    overlap: bool = True,
):
    """nsteps of chi - dt*T@chi with the halo exchange inside the
    shard-local loop: one shard_map region for the whole propagation, so
    no per-step resharding. `overlap=True` uses the interior/boundary
    split so the ppermutes can run concurrently with the bulk stencil."""
    spec3 = P(None, "y", "x")
    stencil = _local_stencil_overlapped if overlap else _local_stencil

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: spec3, coeffs), spec3),
        out_specs=spec3,
    )
    def _run(coeffs_local, chi_local):
        def body(i, c):
            halos = _halo_exchange(c, topology, mesh)
            return c - dt * stencil(coeffs_local, c, halos)

        return jax.lax.fori_loop(0, nsteps, body, chi_local)

    return _run(coeffs, jnp.asarray(chi))
