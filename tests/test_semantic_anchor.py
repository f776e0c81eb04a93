"""Reference-independent semantic anchor: literal operator entries on a
tiny hand-built tripolar grid.

Every other parity test flows through ONE artifact — the numpy oracle in
tests/reference_oracle.py — so a single misreading of the reference
there would be invisible to the whole suite. This test cuts that single
point of failure: the expected values below were derived INDEPENDENTLY,
by a fresh per-entry scalar re-derivation written directly from the
reference Julia source (committed for audit as
tests/anchor_derivation.py, which this test deliberately does NOT
import), and are frozen here as literal constants. Regenerating the
golden cannot touch them.

Grid: 4x3x2 tripolar, one land column at (j=1, i=1), literal volumes /
areas / transports / MLD chosen so several entries reduce to hand-
checkable closed forms (see the arithmetic comments at the pins).
Reference semantics anchored (file:line in /root/reference/src):
  flux closure + no-flux boundaries      velocities.jl:154-243
  upwind advection + donor diagonal      matrixbuilding.jl:193-204,226-299
  surface top-face skip                  matrixbuilding.jl:290
  min-face-area horizontal diffusion     matrixbuilding.jl:337-418
  tripolar fold (j+1 of (i,ny))          gridtopology.jl:94-95
  seam oppdir == :north at j == ny       matrixbuilding.jl:405-409
  mixed-layer / deep vertical diffusion  matrixbuilding.jl:438-479, :85
"""

import math

import numpy as np
import pytest

import otmb_tpu as otmb

NAN = float("nan")
NX, NY, NZ = 4, 3, 2
LEV = [5.0, 15.0]
LAT_C = [10.0, 30.0, 50.0]
LON_C = [45.0, 135.0, 225.0, 315.0]
LAT_E = [0.0, 20.0, 40.0, 60.0]
# Top-row NORTH-edge vertex lons fold back on themselves (NW lon a[i],
# NE lon a[(i+1)%4]) so the tripolar detection rule NE[i] == NW[nx-1-i]
# holds (gridtopology.jl:44).
FOLD_A = [0.0, 90.0, 180.0, 90.0]

UMO = [  # kg/s * 1e-6, [k][j][i]; NaN = missing transport
    [[1.0, -2.0, 0.5, NAN], [2.0, 1.5, -1.0, 0.3], [-0.7, 0.2, 1.1, -0.4]],
    [[0.4, -0.1, 0.0, 0.8], [-1.2, 0.6, 0.9, -0.5], [0.3, -0.8, 0.25, 0.15]],
]
VMO = [
    [[0.6, -0.9, 1.3, 0.2], [-0.5, 0.7, NAN, 1.0], [0.35, -0.6, 0.45, -0.25]],
    [[-0.15, 0.55, -0.65, 0.75], [0.85, -0.95, 0.25, -0.35], [0.5, 0.1, -0.2, 0.6]],
]
MLOTST = [[12.0, 25.0, 4.0, 12.0], [25.0, 7.0, 12.0, 25.0],
          [4.0, 12.0, 25.0, 7.0]]


def _volume(k, j, i):
    if (j, i) == (1, 1):
        return NAN  # land column
    return 1e9 * (1 + 0.5 * k + 0.1 * j + 0.01 * i)


def _area(j, i):
    return 1e7 * (1 + 0.1 * j + 0.01 * i)


def _vertices(i, j):
    """(lon, lat) of SW, SE, NE, NW."""
    sw = (90.0 * i, LAT_E[j])
    se = (90.0 * i + 90.0, LAT_E[j])
    if j == NY - 1:
        nw = (FOLD_A[i], LAT_E[j + 1])
        ne = (FOLD_A[(i + 1) % NX], LAT_E[j + 1])
    else:
        ne = (90.0 * i + 90.0, LAT_E[j + 1])
        nw = (90.0 * i, LAT_E[j + 1])
    return sw, se, ne, nw


# ---------------------------------------------------------------------
# The pinned rows (stencil legs = matrix row of each cell), as derived by
# the independent scalar re-derivation and FROZEN as literals. Keys are
# (k, j, i); legs are (diag, east, west, north, south, top, bottom)
# where leg[d] == T[cell, neighbor_d(cell)].
#
# Hand-checkable closed forms among these (rho=1035, kappa defaults
# kH=500, kVML=0.1, kVdeep=1e-5, dz=|15-5|=10):
#
# * (0,1,0).bottom = -1.0001e-4:
#     advection From Bottom is skipped (the column's closed
#     phi_top[k=1] = (-0.5 - 0.15 - 0 - 0.85)e6 = -1.5e6 < 0, so
#     phi_bottom[k=0] = -1.5e6, max(.,0) = 0), and mlotst[1][0]=25 puts
#     BOTH levels in the mixed layer, so the leg is pure vertical
#     diffusion: -(kVML + kVdeep) * A(1,0) / (dz * V(0,1,0))
#     = -(0.1 + 1e-5) * 1.1e7 / (10 * 1.1e9) = -1.0001e-4.
# * (0,2,3).bottom = -1e-8:
#     mlotst[2][3]=7 -> only k=0 in the ML, so the TkVML pair mask fails
#     and only the deep leg survives: -1e-5 * 1.23e7 / (10 * 1.23e9).
# * (1,0,2).top = -6.7105...e-9:
#     mlotst[0][2]=4 -> no ML at all; -1e-5 * 1.02e7 / (10 * 1.52e9)
#     = -(1.02/1.52)e-8, and advection From Top is zero there.
# * (1,1,2).west = 0 exactly: the west neighbor (1,1,1) is land — the
#     no-flux boundary zeroes the advective flux and the wet-pair mask
#     kills the diffusive leg.
# * (0,2,1).north and (0,2,3).north are the tripolar-fold legs: the
#     north neighbor of (j=2, i) is (j=2, 3-i) (gridtopology.jl:94-95),
#     combining fold advection with the oppdir==:north face-area rule.
# ---------------------------------------------------------------------
EXPECTED_ROWS = {
    (0, 1, 0): {
        "diag": 0.0004517234887153813,
        "east": 0.0,
        "west": -1.2300858456572305e-05,
        "north": -0.0001495198622206595,
        "south": -0.00018980493316770596,
        "top": 0.0,
        "bottom": -0.00010001,
    },
    (1, 0, 2): {
        "diag": 0.0002207254675852871,
        "east": -1.107101302294214e-05,
        "west": -1.110648339658991e-05,
        "north": -0.00019854126063943925,
        "south": 0.0,
        "top": -6.710526315789474e-09,
        "bottom": 0.0,
    },
    (0, 2, 1): {
        "diag": 6.29471770566425e-05,
        "east": -1.5285300804648815e-05,
        "west": -1.5285300804648815e-05,
        "north": -3.2127025800680615e-05,
        "south": 0.0,
        "top": 0.0,
        "bottom": -8.084988222142372e-07,
    },
    (0, 2, 3): {
        "diag": 0.0002403190029560606,
        "east": -1.535096536876158e-05,
        "west": -6.1011103924282465e-05,
        "north": -3.132970485172016e-05,
        "south": -0.00013410970750419928,
        "top": 0.0,
        "bottom": -1.0000000000000002e-08,
    },
    (1, 1, 2): {
        "diag": 0.00034148288211960907,
        "east": -1.1790110042892061e-05,
        "west": 0.0,
        "north": -0.00014271436017359427,
        "south": -0.00018589796101745442,
        "top": -1.080450885668277e-06,
        "bottom": 0.0,
    },
}


@pytest.fixture(scope="module")
def anchor_case():
    vol = np.array([[[_volume(k, j, i) for i in range(NX)]
                     for j in range(NY)] for k in range(NZ)])
    area = np.array([[_area(j, i) for i in range(NX)] for j in range(NY)])
    lon = np.array([[LON_C[i] for i in range(NX)] for _ in range(NY)])
    lat = np.array([[LAT_C[j] for _ in range(NX)] for j in range(NY)])
    vlon = np.zeros((4, NY, NX))
    vlat = np.zeros((4, NY, NX))
    for j in range(NY):
        for i in range(NX):
            for vi, (lo, la) in enumerate(_vertices(i, j)):
                vlon[vi, j, i] = lo
                vlat[vi, j, i] = la
    umo = np.array(UMO) * 1e6
    vmo = np.array(VMO) * 1e6
    gm = otmb.makegridmetrics(
        areacello=area, volcello=vol, lon=lon, lat=lat,
        lev=np.array(LEV), lon_vertices=vlon, lat_vertices=vlat,
    )
    idx = otmb.makeindices(gm.v3d)
    return gm, idx, umo, vmo, np.array(MLOTST)


def test_fold_grid_detected_tripolar(anchor_case):
    gm, *_ = anchor_case
    assert gm.topology.kind == "tripolar"


def _check_rows(coeffs, rtol=1e-12):
    for (k, j, i), row in EXPECTED_ROWS.items():
        for leg, expected in row.items():
            got = float(np.asarray(getattr(coeffs, leg))[k, j, i])
            assert got == pytest.approx(expected, rel=rtol, abs=1e-22), (
                f"T[{(k, j, i)}] leg {leg}: got {got!r}, "
                f"hand-derived {expected!r}"
            )


def test_anchor_rows_xla_pipeline(anchor_case):
    gm, idx, umo, vmo, ml = anchor_case
    phi = otmb.facefluxesfrommasstransport(
        umo=umo, vmo=vmo, gridmetrics=gm, indices=idx
    )
    ops = otmb.transportmatrix(
        phi=phi, mlotst=ml, gridmetrics=gm, indices=idx
    )
    _check_rows(ops.T)
    # land column is exactly zero in every leg
    for leg in ops.T._fields:
        a = np.asarray(getattr(ops.T, leg))
        assert (a[:, 1, 1] == 0.0).all(), f"land row leak in {leg}"


def test_anchor_rows_jit_assembly(anchor_case):
    """The jittable assembly (`assemble_transport`, the path the card
    runs) reproduces the same hand-derived constants."""
    import jax

    from otmb_tpu.models.transport import assemble_transport

    gm, idx, umo, vmo, ml = anchor_case
    coeffs = jax.jit(lambda u, v, m, g, w: assemble_transport(
        u, v, m, g, w).T)(umo, vmo, ml, gm, idx.wet3d)
    _check_rows(coeffs)


def test_anchor_flux_closure_hand_value(anchor_case):
    """One fully hand-computed closure value: the column (j=1, i=0) at
    k=1 has west = umo[1][1][3] = -0.5e6 (its east neighbor (1,1,0) is
    wet), south = vmo[1][0][0] = -0.15e6, east = 0 (east neighbor is the
    land column), north = vmo[1][1][0] = 0.85e6, bottom = 0 (seafloor),
    so phi_top[1,1,0] = -0.5e6 - 0.15e6 - 0 - 0.85e6 = -1.5e6 and
    phi_bottom[0,1,0] = -1.5e6 (velocities.jl:236-243)."""
    gm, idx, umo, vmo, ml = anchor_case
    phi = otmb.facefluxesfrommasstransport(
        umo=umo, vmo=vmo, gridmetrics=gm, indices=idx
    )
    assert float(np.asarray(phi.top)[1, 1, 0]) == pytest.approx(-1.5e6)
    assert float(np.asarray(phi.bottom)[0, 1, 0]) == pytest.approx(-1.5e6)
    # no-flux boundaries: east flux of the land column's west neighbor
    assert float(np.asarray(phi.east)[0, 1, 0]) == 0.0
    # NaN transports are treated as 0 (velocities.jl:203)
    assert float(np.asarray(phi.east)[0, 0, 3]) == 0.0


def test_anchor_independent_haversine():
    """The geometry layer's haversine agrees with an independent
    implementation of the standard formula at the anchor grid's points
    (same Earth radius as Distances.jl's default, 6371 km)."""
    from otmb_tpu.grid.geometry import haversine as repo_hav

    def hav(p, q, r=6_371_000.0):
        lon1, lat1 = map(math.radians, p)
        lon2, lat2 = map(math.radians, q)
        s = (math.sin((lat2 - lat1) / 2) ** 2
             + math.cos(lat1) * math.cos(lat2)
             * math.sin((lon2 - lon1) / 2) ** 2)
        return 2 * r * math.asin(min(1.0, math.sqrt(s)))

    pts = [((45.0, 10.0), (135.0, 10.0)), ((0.0, 40.0), (90.0, 60.0)),
           ((315.0, 50.0), (45.0, 50.0)), ((225.0, 30.0), (225.0, 50.0))]
    for p, q in pts:
        got = float(repo_hav(p[0], p[1], q[0], q[1]))
        assert got == pytest.approx(hav(p, q), rel=1e-12)
