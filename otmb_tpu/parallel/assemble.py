"""Sharded operator assembly: `assemble_transport` partitioned by XLA.

Assembly is a handful of elementwise passes, shifts and one reversed
cumsum over k (the flux closure), and k is never sharded. Under jit with
('y', 'x')-sharded inputs, XLA's SPMD partitioner turns the horizontal
shifts — the periodic i roll, the j concatenations and the tripolar fold
of the top row (gridtopology.jl:94-95) — into collective-permutes and
keeps every output field sharded P(None, 'y', 'x'), ready for the
shard_map solvers and `parallel.halo`. The result equals the
single-device `assemble_transport(...).T` (tested on a virtual CPU mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from ..config import (
    KAPPA_H_DEFAULT,
    KAPPA_VDEEP_DEFAULT,
    KAPPA_VML_DEFAULT,
    RHO_DEFAULT,
)
from ..grid.geometry import GridMetrics
from ..models.transport import assemble_transport
from ..ops.coeffs import StencilCoeffs
from .mesh import field_pspec, shard_pytree


def assemble_T_sharded(
    umo,
    vmo,
    mlotst,
    gridmetrics: GridMetrics,
    mesh: Mesh,
    wet3d=None,
    rho=RHO_DEFAULT,
    kappa_h=KAPPA_H_DEFAULT,
    kappa_vml=KAPPA_VML_DEFAULT,
    kappa_vdeep=KAPPA_VDEEP_DEFAULT,
    upwind: bool = True,
) -> StencilCoeffs:
    """Total operator T as mesh-sharded stencil coefficients (physics:
    matrixbuilding.jl:128-150). `wet3d` defaults to the cells of finite
    volume (`makeindices`' rule); `rho` is a scalar or a 3D field."""
    if gridmetrics.topology.kind == "unknown":
        raise ValueError("assemble_T_sharded requires a known topology")
    if wet3d is None:
        wet3d = jnp.isfinite(gridmetrics.v3d)
    fields = shard_pytree(mesh, (umo, vmo, mlotst, wet3d))
    gm = shard_pytree(mesh, gridmetrics)
    rho_arg = shard_pytree(mesh, rho) if jnp.ndim(rho) == 3 else rho
    out = NamedSharding(mesh, field_pspec(3))

    @jax.jit
    def run(u, v, m, w, g, r):
        T = assemble_transport(u, v, m, g, w, rho=r, kappa_h=kappa_h,
                               kappa_vml=kappa_vml, kappa_vdeep=kappa_vdeep,
                               upwind=upwind).T
        return jax.tree_util.tree_map(
            lambda a: jax.lax.with_sharding_constraint(a, out), T)

    return run(*fields, gm, rho_arg)
