"""Synthetic CMIP-like test grids.

The reference test-suite depends on 100MB+ downloads of ACCESS-ESM1-5
output (test/online.jl:19-65). For hermetic testing we generate small
synthetic datasets with the same structure: curvilinear-capable vertex
arrays, NaN-on-land `volcello`, mass transports with arbitrary values on
land (the pipeline must mask them), and a mixed-layer depth field.

Two topologies are provided:
  * bipolar: regular lat-lon grid whose top edge touches lat=90 so the
    reference detection rule (all top-row NE/NW vertex lats == 90,
    gridtopology.jl:41-42) classifies it bipolar;
  * tripolar: same, but the top edge is a constant-latitude seam whose
    vertex longitudes are palindromic in i, which makes the north edge map
    onto itself under rot180 — the reference's tripolar signature
    (gridtopology.jl:44).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import EARTH_RADIUS


@dataclasses.dataclass
class SyntheticDataset:
    """Raw fields in canonical layout, as a CMIP dataset would provide."""

    areacello: np.ndarray  # (ny, nx)
    volcello: np.ndarray  # (nz, ny, nx), NaN on land
    lon: np.ndarray  # (ny, nx)
    lat: np.ndarray  # (ny, nx)
    lev: np.ndarray  # (nz,)
    lon_vertices: np.ndarray  # (4, ny, nx)
    lat_vertices: np.ndarray  # (4, ny, nx)
    umo: np.ndarray  # (nz, ny, nx) eastward mass transport, kg/s
    vmo: np.ndarray  # (nz, ny, nx) northward mass transport, kg/s
    mlotst: np.ndarray  # (ny, nx) mixed-layer depth, m
    wet3d: np.ndarray  # (nz, ny, nx) bool (ground truth)


def _level_thicknesses(nz: int) -> np.ndarray:
    """Ocean-like stretched levels: ~10 m at the top, growing with depth."""
    k = np.arange(nz)
    return 10.0 * (1.0 + 0.35 * k)


def _cell_areas(lat_edges: np.ndarray, nx: int) -> np.ndarray:
    """Exact spherical quad areas for a regular lat-lon grid, (ny, nx)."""
    dlam = 2 * np.pi / nx
    sin_edges = np.sin(np.deg2rad(lat_edges))
    band = EARTH_RADIUS**2 * dlam * np.diff(sin_edges)  # (ny,)
    return np.repeat(band[:, None], nx, axis=1)


def _seafloor_levels(nx: int, ny: int, nz: int, rng: np.random.Generator,
                     land_fraction: float) -> np.ndarray:
    """Number of wet levels per column (0 => land column)."""
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    # Smooth bathymetry: deep basins with shallower shelves.
    depth = (
        0.55
        + 0.35 * np.sin(2 * np.pi * ii / nx + 1.0) * np.cos(np.pi * jj / ny)
        + 0.25 * np.cos(4 * np.pi * ii / nx) * np.sin(2 * np.pi * jj / ny + 0.5)
    )
    kbot = np.clip(np.round(depth * nz), 1, nz).astype(int)
    if land_fraction > 0:
        # A continent: a lon-lat rectangle, plus random islands.
        i0, i1 = int(0.15 * nx), int(0.15 * nx + max(1, land_fraction * nx))
        j0, j1 = int(0.3 * ny), int(0.75 * ny)
        kbot[j0:j1, i0:i1] = 0
        n_islands = max(1, (nx * ny) // 50)
        isl_i = rng.integers(0, nx, n_islands)
        isl_j = rng.integers(0, ny, n_islands)
        kbot[isl_j, isl_i] = 0
    return kbot


def _smooth_field(shape, rng: np.random.Generator, scale: float) -> np.ndarray:
    """Random smooth 3D field via a few low-wavenumber harmonics."""
    nz, ny, nx = shape
    k = np.arange(nz)[:, None, None]
    j = np.arange(ny)[None, :, None]
    i = np.arange(nx)[None, None, :]
    out = np.zeros(shape)
    for _ in range(4):
        ak, aj, ai = rng.integers(1, 4, 3)
        pk, pj, pi = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.3, 1.0)
        out += amp * (
            np.cos(2 * np.pi * ai * i / nx + pi)
            * np.cos(np.pi * aj * j / ny + pj)
            * np.cos(np.pi * ak * k / nz + pk)
        )
    return scale * out


def synthetic_device_case(
    nx: int,
    ny: int,
    nz: int,
    topology: str = "tripolar",
    dtype=None,
    seed: int = 0,
):
    """Large-scale benchmark case generated ON DEVICE.

    Returns (gridmetrics, wet3d, umo, vmo, mlotst) with every 3D field
    created by jnp ops on the default device — only O(ny*nx) host data is
    transferred, which matters at the 0.25-degree scale (10^8 cells).

    The geometry matches `synthetic_dataset` + `makegridmetrics` up to the
    field-generation RNG (harmonic phases come from numpy, so the *flow*
    differs from the host path, but the grid/topology/metrics are the
    same construction).
    """
    import jax
    import jax.numpy as jnp

    from ..grid import geometry as geo
    from ..grid.topology import detect_topology

    if dtype is None:
        dtype = jnp.float32
    if nx % 2 != 0:
        raise ValueError("nx must be even for the tripolar fold")
    rng = np.random.default_rng(seed)

    lat_north_edge = {"bipolar": 90.0, "tripolar": 66.0}[topology]
    lat_edges = np.linspace(-78.0, lat_north_edge, ny + 1)
    lon_edges = np.linspace(0.0, 360.0, nx + 1)

    vlon = np.zeros((4, ny, nx))
    vlat = np.zeros((4, ny, nx))
    vlon[0] = lon_edges[None, :-1]
    vlon[1] = lon_edges[None, 1:]
    vlon[2] = lon_edges[None, 1:]
    vlon[3] = lon_edges[None, :-1]
    vlat[0] = lat_edges[:-1, None]
    vlat[1] = lat_edges[:-1, None]
    vlat[2] = lat_edges[1:, None]
    vlat[3] = lat_edges[1:, None]
    if topology == "tripolar":
        p = np.empty(nx + 1)
        half = nx // 2
        p[: half + 1] = 80.0 + np.arange(half + 1) * (180.0 / half)
        for i in range(half + 1, nx + 1):
            p[i] = p[nx - i]
        vlon[3, ny - 1, :] = p[:-1]
        vlon[2, ny - 1, :] = p[1:]
        vlat[2:, ny - 1, :] = lat_north_edge

    lon2d = 0.5 * (lon_edges[:-1] + lon_edges[1:])[None, :].repeat(ny, axis=0)
    lat2d = 0.5 * (lat_edges[:-1] + lat_edges[1:])[:, None].repeat(nx, axis=1)

    thick = _level_thicknesses(nz)
    lev = np.cumsum(thick) - 0.5 * thick
    area = _cell_areas(lat_edges, nx)
    kbot = _seafloor_levels(nx, ny, nz, rng, land_fraction=0.15)

    topo = detect_topology(vlon, vlat, nz)

    # --- device-side 3D fields ---
    area_d = jnp.asarray(np.where(kbot > 0, area, np.nan), dtype)
    kbot_d = jnp.asarray(kbot)
    thick_d = jnp.asarray(thick, dtype).reshape(nz, 1, 1)

    @jax.jit
    def build_3d(area_, kbot_, thick_):
        wet = jnp.arange(nz).reshape(nz, 1, 1) < kbot_[None]
        v3d = jnp.where(wet, area_[None] * thick_, jnp.nan)
        thk = v3d / area_[None]
        zbot = jnp.cumsum(thk, axis=0)
        z3d = zbot - 0.5 * thk
        # smooth flow harmonics, NaN junk on land like CMIP output
        k = jnp.arange(nz, dtype=dtype).reshape(nz, 1, 1)
        j = jnp.arange(ny, dtype=dtype).reshape(1, ny, 1)
        i = jnp.arange(nx, dtype=dtype).reshape(1, 1, nx)
        umo = 1e8 * (
            jnp.cos(2 * jnp.pi * 2 * i / nx + 0.3)
            * jnp.cos(jnp.pi * 1 * j / ny + 1.1)
            * jnp.cos(jnp.pi * 2 * k / nz + 0.7)
            + 0.5 * jnp.cos(2 * jnp.pi * 3 * i / nx + 2.0)
            * jnp.cos(jnp.pi * 2 * j / ny)
        )
        vmo = 1e8 * (
            jnp.cos(2 * jnp.pi * 1 * i / nx + 1.7)
            * jnp.cos(jnp.pi * 2 * j / ny + 0.2)
            * jnp.cos(jnp.pi * 1 * k / nz + 1.9)
        )
        if topo.is_tripolar:
            top = vmo[:, ny - 1, :]
            vmo = vmo.at[:, ny - 1, :].set(0.5 * (top - top[:, ::-1]))
        umo = jnp.where(wet, umo, jnp.nan)
        vmo = jnp.where(wet, vmo, jnp.nan)
        return wet, v3d, thk, z3d, umo, vmo

    wet, v3d, thk, z3d, umo, vmo = build_3d(area_d, kbot_d, thick_d)

    lon_j = jnp.asarray(lon2d, dtype)
    lat_j = jnp.asarray(lat2d, dtype)
    vlon_j = jnp.asarray(vlon, dtype)
    vlat_j = jnp.asarray(vlat, dtype)

    gm = geo.GridMetrics(
        area2d=area_d,
        v3d=v3d,
        thkcello=thk,
        lon=lon_j,
        lat=lat_j,
        lon_vertices=vlon_j,
        lat_vertices=vlat_j,
        z3d=z3d,
        zt=jnp.asarray(lev, dtype),
        edge_length=geo.edge_lengths(vlon_j, vlat_j),
        distance_to_edge=geo.distances_to_edge(lon_j, lat_j, vlon_j, vlat_j),
        distance_to_neighbour=geo.distances_to_neighbour(lon_j, lat_j, topo),
        topology=topo,
    )
    mlotst = jnp.asarray(
        np.where(kbot > 0, rng.uniform(15.0, 0.8 * float(lev[-1]), (ny, nx)),
                 np.nan),
        dtype,
    )
    return gm, wet, umo, vmo, mlotst


def synthetic_dataset(
    nx: int = 18,
    ny: int = 14,
    nz: int = 6,
    topology: str = "tripolar",
    land_fraction: float = 0.15,
    seed: int = 0,
    antisymmetric_seam: bool = True,
    lat_south: float = -78.0,
) -> SyntheticDataset:
    """Generate a synthetic dataset.

    For `topology="tripolar"`, the top row of cells has its north edge on a
    constant-latitude seam with palindromic vertex longitudes, so cell
    (ny-1, i) shares its north edge with cell (ny-1, nx-1-i). If
    `antisymmetric_seam`, vmo on the top row satisfies
    vmo[i] = -vmo[nx-1-i] (a physically consistent cross-seam transport).

    For `topology="bipolar"`, the top edge lies exactly on lat=90.
    """
    if nx % 2 != 0:
        raise ValueError("nx must be even for the tripolar fold")
    rng = np.random.default_rng(seed)

    if topology == "bipolar":
        lat_north_edge = 90.0
    elif topology == "tripolar":
        lat_north_edge = 66.0
    else:
        raise ValueError(f"unknown topology {topology!r}")

    # Regular latitude rows: ny+1 edges from lat_south to lat_north_edge.
    lat_edges = np.linspace(lat_south, lat_north_edge, ny + 1)
    lon_edges = np.linspace(0.0, 360.0, nx + 1)

    # Vertex arrays (4, ny, nx): SW, SE, NE, NW.
    vlon = np.zeros((4, ny, nx))
    vlat = np.zeros((4, ny, nx))
    vlon[0] = lon_edges[None, :-1]
    vlon[1] = lon_edges[None, 1:]
    vlon[2] = lon_edges[None, 1:]
    vlon[3] = lon_edges[None, :-1]
    vlat[0] = lat_edges[:-1, None]
    vlat[1] = lat_edges[:-1, None]
    vlat[2] = lat_edges[1:, None]
    vlat[3] = lat_edges[1:, None]

    if topology == "tripolar":
        # Palindromic vertex longitudes along the seam (p[i] == p[nx - i]).
        p = np.empty(nx + 1)
        lam0 = 80.0
        half = nx // 2
        p[: half + 1] = lam0 + (np.arange(half + 1)) * (360.0 / half) / 2.0
        for i in range(half + 1, nx + 1):
            p[i] = p[nx - i]
        vlon[3, ny - 1, :] = p[:-1]  # NW
        vlon[2, ny - 1, :] = p[1:]  # NE
        vlat[3, ny - 1, :] = lat_north_edge
        vlat[2, ny - 1, :] = lat_north_edge

    lon = 0.5 * (lon_edges[:-1] + lon_edges[1:])[None, :].repeat(ny, axis=0)
    lat = 0.5 * (lat_edges[:-1] + lat_edges[1:])[:, None].repeat(nx, axis=1)

    thick = _level_thicknesses(nz)
    lev = np.cumsum(thick) - 0.5 * thick

    area = _cell_areas(lat_edges, nx)
    kbot = _seafloor_levels(nx, ny, nz, rng, land_fraction)
    wet3d = np.arange(nz)[:, None, None] < kbot[None, :, :]

    volcello = np.where(wet3d, area[None] * thick[:, None, None], np.nan)

    # Mass transports: smooth + noise; junk (NaN) on land to exercise the
    # masking path, like CMIP output.
    umo = _smooth_field((nz, ny, nx), rng, 1e8)
    vmo = _smooth_field((nz, ny, nx), rng, 1e8)
    if topology == "tripolar" and antisymmetric_seam:
        top = vmo[:, ny - 1, :]
        vmo[:, ny - 1, :] = 0.5 * (top - top[:, ::-1])
    umo[~wet3d] = np.nan
    vmo[~wet3d] = np.nan

    mlotst = rng.uniform(15.0, 0.8 * float(lev[-1]), size=(ny, nx))
    mlotst[kbot == 0] = np.nan

    return SyntheticDataset(
        areacello=np.where(kbot > 0, area, np.nan),
        volcello=volcello,
        lon=lon,
        lat=lat,
        lev=lev,
        lon_vertices=vlon,
        lat_vertices=vlat,
        umo=umo,
        vmo=vmo,
        mlotst=mlotst,
        wet3d=wet3d,
    )
