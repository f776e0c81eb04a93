"""Literal per-cell oracle reproducing the reference algorithms in numpy.

This module intentionally mirrors the *loop-level* semantics of
/root/reference/src (velocities.jl, matrixbuilding.jl) cell by cell, as a
slow but unambiguous specification to validate the vectorized
implementation against. It is test-only code.

Conventions: canonical layout (nz, ny, nx), 0-based; a "cell" is the tuple
c = (k, j, i). Neighbor functions return None where the reference returns
`nothing`.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


# --- neighbor functions (reference gridtopology.jl:57-95) -----------------


def i_p1(c, topo):
    k, j, i = c
    return (k, j, (i + 1) % topo.nx)


def i_m1(c, topo):
    k, j, i = c
    return (k, j, (i - 1) % topo.nx)


def j_p1(c, topo):
    k, j, i = c
    if j < topo.ny - 1:
        return (k, j + 1, i)
    if topo.is_tripolar:
        return (k, topo.ny - 1, topo.nx - 1 - i)
    return None


def j_m1(c, topo):
    k, j, i = c
    return (k, j - 1, i) if j > 0 else None


def k_p1(c, topo):
    k, j, i = c
    return (k + 1, j, i) if k < topo.nz - 1 else None


def k_m1(c, topo):
    k, j, i = c
    return (k - 1, j, i) if k > 0 else None


# --- face fluxes (reference velocities.jl:154-255) ------------------------


def oracle_facefluxes(umo, vmo, wet3d, topo, fill_value=None):
    nz, ny, nx = wet3d.shape

    def sanitize(x):
        x = np.where(np.isfinite(x), x, 0.0)
        if fill_value is not None:
            x = np.where(x == fill_value, 0.0, x)
        return x.astype(np.float64)

    phi_e = sanitize(np.asarray(umo, np.float64))
    phi_n = sanitize(np.asarray(vmo, np.float64))

    # nofluxboundaries!
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                c = (k, j, i)
                E = i_p1(c, topo)
                N = j_p1(c, topo)
                if not wet3d[c]:
                    phi_e[c] = 0.0
                    phi_n[c] = 0.0
                if E is None or not wet3d[E]:
                    phi_e[c] = 0.0
                if N is None or not wet3d[N]:
                    phi_n[c] = 0.0

    phi_w = np.zeros_like(phi_e)
    phi_s = np.zeros_like(phi_n)
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                c = (k, j, i)
                W = i_m1(c, topo)
                if W is not None:
                    phi_w[c] = phi_e[W]
                S = j_m1(c, topo)
                if S is not None:
                    phi_s[c] = phi_n[S]

    phi_t = np.zeros_like(phi_e)
    phi_b = np.zeros_like(phi_e)
    for k in reversed(range(nz)):
        if k == nz - 1:
            phi_b[k] = 0.0
        else:
            phi_b[k] = phi_t[k + 1]
        phi_t[k] = phi_b[k] + phi_w[k] + phi_s[k] - phi_e[k] - phi_n[k]

    return dict(east=phi_e, west=phi_w, north=phi_n, south=phi_s, top=phi_t,
                bottom=phi_b)


# --- sparse assembly (reference matrixbuilding.jl) ------------------------


def _wet_cells(wet3d):
    """Wet cells in C-order linear order, with the wet-index map."""
    nz, ny, nx = wet3d.shape
    lwet3d = np.full((nz, ny, nx), -1, dtype=np.int64)
    cells = []
    n = 0
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                if wet3d[k, j, i]:
                    lwet3d[k, j, i] = n
                    cells.append((k, j, i))
                    n += 1
    return cells, lwet3d


def oracle_advection_matrix(phi, v3d, rho, wet3d, topo, upwind=True):
    """advection_operator_sparse_entries (matrixbuilding.jl:226-299)."""
    cells, lwet3d = _wet_cells(wet3d)
    n = len(cells)
    rho = np.broadcast_to(np.asarray(rho, np.float64), v3d.shape)
    rows, cols, vals = [], [], []

    def push(i_idx, j_idx, f, rho_i, rho_j, v_i, v_j):
        rho_m = (rho_i + rho_j) / 2
        rows.append(i_idx)
        cols.append(j_idx)
        vals.append(-f / (rho_m * v_i))
        rows.append(j_idx)
        cols.append(j_idx)
        vals.append(f / (rho_m * v_j))

    # (direction, flux field, neighbor fn, sign, skip_at_surface)
    branches = [
        ("west", i_m1, +1, False),
        ("east", i_p1, -1, False),
        ("south", j_m1, +1, False),
        ("north", j_p1, -1, False),
        ("bottom", k_p1, +1, False),
        ("top", k_m1, -1, True),
    ]

    for idx, c in enumerate(cells):
        k = c[0]
        v_i = v3d[c]
        rho_i = rho[c]
        for name, nb_fn, sign, skip_surface in branches:
            raw = phi[name][c]
            if upwind:
                f = max(raw, 0.0) if sign > 0 else min(raw, 0.0)
            else:
                f = raw / 2
            if skip_surface and k == 0:
                continue
            if f == 0.0:
                continue
            cj = nb_fn(c, topo)
            jdx = lwet3d[cj]
            assert jdx >= 0, f"flux into dry/absent neighbor at {c} {name}"
            push(idx, jdx, sign * f, rho_i, rho[cj], v_i, v3d[cj])

    mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    mat.sum_duplicates()
    return mat


def oracle_horizontal_diffusion_matrix(gm_np, wet3d, topo, kappa_h):
    """horizontal_diffusion_operator_sparse_entries
    (matrixbuilding.jl:337-418). `gm_np` carries numpy copies of thkcello,
    edge_length (dict of 2D), distance_to_neighbour (dict of 2D), v3d."""
    cells, lwet3d = _wet_cells(wet3d)
    n = len(cells)
    ny = topo.ny
    rows, cols, vals = [], [], []

    thk = gm_np["thkcello"]
    v3d = gm_np["v3d"]
    el = gm_np["edge_length"]
    d2n = gm_np["distance_to_neighbour"]

    def facearea(c, direction):
        k, j, i = c
        return thk[k, j, i] * el[direction][j, i]

    def push(i_idx, j_idx, tval):
        rows.extend([i_idx, i_idx])
        cols.extend([i_idx, j_idx])
        vals.extend([tval, -tval])

    branches = [
        ("west", i_m1, "east"),
        ("east", i_p1, "west"),
        ("south", j_m1, "north"),
        ("north", j_p1, "south"),
    ]

    for idx, c in enumerate(cells):
        k, j, i = c
        V = v3d[c]
        for name, nb_fn, oppdir in branches:
            cj = nb_fn(c, topo)
            if cj is None:
                continue
            jdx = lwet3d[cj]
            if jdx < 0:
                continue
            if name == "north" and j == ny - 1:
                # oppdir is still north across the seam (matrixbuilding.jl:405-409)
                oppdir = "north"
            a = min(facearea(c, name), facearea(cj, oppdir))
            d = d2n[name][j, i]
            push(idx, jdx, kappa_h * a / (d * V))

    mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    mat.sum_duplicates()
    return mat


def oracle_vertical_diffusion_matrix(gm_np, wet3d, topo, kappa_v, omega=None):
    """vertical_diffusion_operator_sparse_entries (matrixbuilding.jl:438-479).

    `omega`: boolean (nz, ny, nx) mask or None for whole ocean.
    """
    cells, lwet3d = _wet_cells(wet3d)
    n = len(cells)
    rows, cols, vals = [], [], []

    v3d = gm_np["v3d"]
    area = gm_np["area2d"]
    zt = gm_np["zt"]
    if omega is None:
        omega = np.ones_like(wet3d, dtype=bool)

    def push(i_idx, j_idx, tval):
        rows.extend([i_idx, i_idx])
        cols.extend([i_idx, j_idx])
        vals.extend([tval, -tval])

    for idx, c in enumerate(cells):
        k, j, i = c
        if not omega[c]:
            continue
        V = v3d[c]
        a = area[j, i]
        for nb_fn in (k_p1, k_m1):
            cj = nb_fn(c, topo)
            if cj is None:
                continue
            jdx = lwet3d[cj]
            if jdx < 0 or not omega[cj]:
                continue
            d = abs(zt[k] - zt[cj[0]])
            push(idx, jdx, kappa_v * a / (d * V))

    mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    mat.sum_duplicates()
    return mat


def gm_to_numpy(gridmetrics):
    """Extract numpy copies of the metric fields the oracles need."""
    el = {d: np.asarray(gridmetrics.edge_length[d]) for d in
          ("east", "west", "north", "south")}
    d2n = {d: np.asarray(gridmetrics.distance_to_neighbour[d]) for d in
           ("east", "west", "north", "south")}
    return dict(
        thkcello=np.asarray(gridmetrics.thkcello),
        v3d=np.asarray(gridmetrics.v3d),
        area2d=np.asarray(gridmetrics.area2d),
        zt=np.asarray(gridmetrics.zt),
        edge_length=el,
        distance_to_neighbour=d2n,
    )
