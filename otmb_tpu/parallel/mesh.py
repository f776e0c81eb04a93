"""Device mesh and sharding for multi-chip domain decomposition.

The reference is single-threaded Julia with no distributed code (SURVEY
section 2.2); scale-out here is new architecture: all
(nz, ny, nx) fields are sharded over a 2D ('y', 'x') device mesh —
horizontal domain decomposition, the structured-grid analogue of
tensor/sequence parallelism. The k (depth) axis stays local to each shard
because both the grid preprocessing (cumsum over k) and the flux closure
(reversed cumsum over k) are sequential in k.

Under jit/GSPMD the topology shifts (roll in i, shifted concats in j, the
tripolar fold) lower to XLA collective-permutes automatically (NCCL on
GPUs);
`parallel/halo.py` provides the explicit shard_map halo-exchange variant
for the hand-tuned path.

Mesh shape: `make_grid_mesh` defaults to the most-square factorization.
On cards joined all to all (NVLink) the shape follows the algorithm
alone: `mesh_shape=(n, 1)` splits only j, so each halo is a contiguous
row, the periodic i wrap stays shard-local, and the tripolar fold is
exchanged within the top shard — two collective-permutes per matvec
instead of five.

Multi-host: call `jax.distributed.initialize()` before building the mesh;
`make_grid_mesh` then spans all processes' devices.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..grid.geometry import GridMetrics, PerDirection
from ..ops.coeffs import StencilCoeffs
from ..ops.fluxes import FaceFluxes


def _factor2d(n: int) -> tuple[int, int]:
    """Most-square factorization a*b == n with a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_grid_mesh(devices=None, mesh_shape: tuple[int, int] | None = None) -> Mesh:
    """2D ('y', 'x') mesh over the given devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = _factor2d(n)
    ny_dev, nx_dev = mesh_shape
    if ny_dev * nx_dev != n:
        raise ValueError(f"mesh shape {mesh_shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(ny_dev, nx_dev)
    return Mesh(dev_array, ("y", "x"))


def field_pspec(ndim: int) -> P:
    """PartitionSpec for a canonical field: trailing (ny, nx) sharded over
    ('y', 'x'), every leading axis (k, vertex, ...) replicated/local."""
    if ndim < 2:
        return P()
    return P(*([None] * (ndim - 2)), "y", "x")


def sharding_for(mesh: Mesh, x) -> NamedSharding:
    ndim = x.ndim if hasattr(x, "ndim") else np.asarray(x).ndim
    return NamedSharding(mesh, field_pspec(ndim))


def shard_pytree(mesh: Mesh, tree):
    """device_put every array leaf with its canonical-field sharding.

    1D arrays (zt) and scalars are replicated; anything with trailing
    (ny, nx) is sharded over the mesh.
    """
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, sharding_for(mesh, leaf)), tree
    )


def pspec_tree(tree):
    """Matching pytree of PartitionSpecs (for in_shardings/out_shardings)."""
    return jax.tree_util.tree_map(lambda leaf: field_pspec(np.asarray(leaf).ndim), tree)


def initialize_distributed(**kwargs) -> None:
    """Multi-host startup: call once per process before building the mesh.

    Thin wrapper over `jax.distributed.initialize`: pass
    `coordinator_address` ("host:port"), `num_processes` and
    `process_id` unless the cluster environment provides them. After
    this, `jax.devices()` spans every process and `make_grid_mesh()`
    builds a global ('y', 'x') mesh.
    """
    jax.distributed.initialize(**kwargs)
