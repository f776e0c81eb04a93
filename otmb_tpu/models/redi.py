"""Redi isoneutral diffusion as a matrix-free conservative operator.

The reference stops at the experimental GM bolus velocity (RediGM.jl); the
along-isopycnal (Redi) diffusion tensor itself is left unimplemented.
Here it is provided as a finite-volume flux divergence with
the small-slope Redi tensor (Redi 1982), slopes from the same triads and
clamp/taper as the GM path (reference RediGM.jl:52-64):

    K = kappa * [[1,   0,   Sx ],
                 [0,   1,   Sy ],
                 [Sx,  Sy,  S^2]]        (coordinates x, y, zeta=height)

    d(chi)/dt = div(K grad chi)

Discretization: one flux value per face, oriented +x (east faces), +y
(north faces), +zeta/up (top faces); each face value is added to its cell
and subtracted from the neighbor, so

  * total tracer (volume integral) is conserved to roundoff by
    telescoping — including across the periodic boundary and the tripolar
    seam (seam pairs cancel exactly because the cross term is disabled on
    seam faces, where the j-orientation flips);
  * constants are in the null space (all terms are chi-differences).

The stencil is 19-point; the operator is exposed as an apply function (a
RediOperator pytree + `redi_apply`), composable with the 7-point stencil:

    dchi/dt = -apply_stencil(T, chi, topo) + redi_apply(op, chi)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import KAPPA_GM_DEFAULT, MAXSLOPE_DEFAULT
from ..grid.geometry import GridMetrics
from ..grid.topology import GridTopology, neighbor_valid, neighbor_values
from ..ops.derivatives import vertical_face_triad_derivative
from .redigm import slope_taper


def _safe(x):
    return jnp.where(jnp.isfinite(x), x, 0.0)


def _masked_mean2(a, b):
    """NaN-aware mean of two one-sided estimates (Julia strong-zero style)."""
    wa = jnp.isfinite(a)
    wb = jnp.isfinite(b)
    return (jnp.where(wa, _safe(a), 0.0) + jnp.where(wb, _safe(b), 0.0)) / (
        jnp.maximum(wa + wb, 1)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RediOperator:
    """Precomputed face geometry, tapered slopes, and derivative weights.

    The operator is stored in pure *linear-coefficient* form: every mask,
    NaN-guard, and distance division of the discretization is folded into
    chi-independent coefficient fields at build time, so the apply is a
    branch-free multiply-add stencil (jnp or the fused Pallas kernel) —
    cell-centered derivatives are

        dc/dzeta = cz_u * (chi_up - chi) + cz_d * (chi - chi_dn)

    with cz_* already carrying the one-sided-estimate weights (the
    NaN-aware mean of dyads.jl semantics) and the 1/distance. All `a*`
    face factors are exactly zero on faces touching land or the domain
    boundary, which enforces no-flux boundaries.
    """

    ae: jax.Array  # east faces: kappa * A
    s_e: jax.Array  # east-face slope S_x
    an: jax.Array  # north faces: kappa * A
    s_n: jax.Array
    at: jax.Array  # top faces: kappa * A
    s_ti: jax.Array  # top-face S_x
    s_tj: jax.Array  # top-face S_y
    g_t: jax.Array  # top faces: (S_x^2 + S_y^2) / dz
    cz_u: jax.Array  # weights of the cell-centered derivatives
    cz_d: jax.Array
    cx_e: jax.Array
    cx_w: jax.Array
    cy_n: jax.Array
    cy_s: jax.Array
    inv_de: jax.Array  # (ny, nx) 1 / center-to-east-neighbor distance
    inv_dn: jax.Array  # (ny, nx) 1 / center-to-north-neighbor distance
    inv_v: jax.Array  # 1/V on wet cells, 0 on land
    wet: jax.Array
    topology: GridTopology = dataclasses.field(metadata=dict(static=True))


def build_redi_operator(
    rho,
    gridmetrics: GridMetrics,
    wet3d,
    kappa_redi: float = KAPPA_GM_DEFAULT,
    maxslope: float = MAXSLOPE_DEFAULT,
) -> RediOperator:
    """Precompute geometry and density slopes for the Redi operator."""
    gm = gridmetrics
    topo = gm.topology
    wet = jnp.asarray(wet3d, bool)
    ny = topo.ny

    # Cell-centered isoneutral slopes, clamped + tapered (RediGM.jl:56-64).
    # The triad returns rho_x / rho_zeta; the isopycnal-surface slope of
    # the rotated tensor is S_x = -rho_x / rho_zeta, hence the negation.
    s_i = -vertical_face_triad_derivative(rho, gm, "i", wet)
    s_j = -vertical_face_triad_derivative(rho, gm, "j", wet)
    s_i = jnp.clip(_safe(s_i), -maxslope, maxslope)
    s_j = jnp.clip(_safe(s_j), -maxslope, maxslope)
    taper = slope_taper(s_i, s_j)
    s_i = taper * s_i
    s_j = taper * s_j

    def face_mean(x, direction):
        return 0.5 * (x + _safe(neighbor_values(x, direction, topo, fill=jnp.nan)))

    # --- east faces ---
    e_wet = wet & neighbor_values(wet, "east", topo, fill=False)
    thk_e = jnp.minimum(
        gm.thkcello, neighbor_values(gm.thkcello, "east", topo, fill=jnp.nan)
    )
    area_e = jnp.where(e_wet, thk_e * gm.edge_length["east"], 0.0)
    ae = kappa_redi * _safe(area_e)
    s_e = jnp.where(e_wet, face_mean(s_i, "east"), 0.0)

    # --- north faces ---
    n_wet = (
        wet
        & neighbor_values(wet, "north", topo, fill=False)
        & neighbor_valid("north", topo)
    )
    thk_n = jnp.minimum(
        gm.thkcello, neighbor_values(gm.thkcello, "north", topo, fill=jnp.nan)
    )
    area_n = jnp.where(n_wet, thk_n * gm.edge_length["north"], 0.0)
    an = kappa_redi * _safe(area_n)
    s_n = jnp.where(n_wet, face_mean(s_j, "north"), 0.0)
    if topo.is_tripolar:
        # Across the seam the j-orientation flips, which would break the
        # antisymmetric pairing of the cross term; disable it there (the
        # pure horizontal part remains and pairs exactly).
        seam_mask = jnp.ones((ny, 1), bool).at[ny - 1].set(False).reshape(1, ny, 1)
        s_n = jnp.where(seam_mask, s_n, 0.0)

    # --- top faces (between each cell and the one above) ---
    t_wet = wet & neighbor_values(wet, "top", topo, fill=False)
    z = gm.z3d
    dz_up = jnp.abs(neighbor_values(z, "top", topo, fill=jnp.nan) - z)
    dz_up_safe = jnp.where(t_wet, dz_up, 1.0)
    b_wet = wet & neighbor_values(wet, "bottom", topo, fill=False)
    dz_dn = jnp.abs(neighbor_values(z, "bottom", topo, fill=jnp.nan) - z)
    dz_dn_safe = jnp.where(jnp.isfinite(dz_dn), dz_dn, 1.0)
    at = jnp.where(t_wet, kappa_redi * gm.area2d, 0.0)
    s_ti = jnp.where(t_wet, face_mean(s_i, "top"), 0.0)
    s_tj = jnp.where(t_wet, face_mean(s_j, "top"), 0.0)
    g_t = (s_ti**2 + s_tj**2) / dz_up_safe

    # --- cell-centered derivative weights (chi-independent) ---
    # dcz = cz_u*(chi_up - chi) + cz_d*(chi - chi_dn): the NaN-aware mean
    # of the one-sided estimates, with weight 1 only where both cells of
    # the leg are wet (and the neighbor exists) and 1/distance folded in.
    dist = gm.distance_to_neighbour

    def deriv_weights(w_fwd, d_fwd, w_bwd, d_bwd):
        wf = w_fwd & jnp.isfinite(d_fwd)
        wb = w_bwd & jnp.isfinite(d_bwd)
        den = jnp.maximum(wf.astype(at.dtype) + wb.astype(at.dtype), 1.0)
        cf = jnp.where(wf, 1.0 / (den * jnp.where(wf, d_fwd, 1.0)), 0.0)
        cb = jnp.where(wb, 1.0 / (den * jnp.where(wb, d_bwd, 1.0)), 0.0)
        return cf, cb

    w_wet = wet & neighbor_values(wet, "west", topo, fill=False)
    s_wetm = (
        wet
        & neighbor_values(wet, "south", topo, fill=False)
        & neighbor_valid("south", topo)
    )
    cz_u, cz_d = deriv_weights(t_wet, dz_up_safe, b_wet, dz_dn_safe)
    cx_e, cx_w = deriv_weights(e_wet, dist["east"], w_wet, dist["west"])
    cy_n, cy_s = deriv_weights(n_wet, dist["north"], s_wetm, dist["south"])

    return RediOperator(
        ae=ae, s_e=s_e, an=an, s_n=s_n,
        at=at, s_ti=s_ti, s_tj=s_tj, g_t=g_t,
        cz_u=cz_u, cz_d=cz_d, cx_e=cx_e, cx_w=cx_w, cy_n=cy_n, cy_s=cy_s,
        inv_de=_safe(1.0 / gm.distance_to_neighbour["east"]),
        inv_dn=_safe(1.0 / gm.distance_to_neighbour["north"]),
        inv_v=jnp.where(wet, 1.0 / gm.v3d, 0.0),
        wet=wet,
        topology=topo,
    )


@jax.jit
def redi_apply(op: RediOperator, chi):
    """d(chi)/dt contribution of Redi isoneutral diffusion (chi/s).

    Branch-free linear stencil: every mask/NaN-guard lives in the
    precomputed coefficients (see RediOperator), so this is seven shifted
    multiply-adds per stage, which XLA fuses.
    """
    topo = op.topology
    chi = jnp.where(op.wet, jnp.asarray(chi), 0.0)

    nb = lambda x, d: neighbor_values(x, d, topo, fill=0.0)
    chi_e, chi_w = nb(chi, "east"), nb(chi, "west")
    chi_n, chi_s = nb(chi, "north"), nb(chi, "south")
    chi_u, chi_d = nb(chi, "top"), nb(chi, "bottom")

    # Cell-centered derivatives (weights carry masks and 1/distance).
    dcz = op.cz_u * (chi_u - chi) + op.cz_d * (chi - chi_d)
    dcx = op.cx_e * (chi_e - chi) + op.cx_w * (chi - chi_w)
    dcy = op.cy_n * (chi_n - chi) + op.cy_s * (chi - chi_s)

    # --- east-face flux (+x orientation) ---
    dcz_e = 0.5 * (dcz + nb(dcz, "east"))
    f_e = op.ae * (op.inv_de * (chi_e - chi) + op.s_e * dcz_e)

    # --- north-face flux (+y orientation; seam cross term disabled) ---
    dcz_n = 0.5 * (dcz + nb(dcz, "north"))
    f_n = op.an * (op.inv_dn * (chi_n - chi) + op.s_n * dcz_n)

    # --- top-face flux (+zeta / upward orientation) ---
    dcx_t = 0.5 * (dcx + nb(dcx, "top"))
    dcy_t = 0.5 * (dcy + nb(dcy, "top"))
    f_t = op.at * (op.s_ti * dcx_t + op.s_tj * dcy_t
                   + op.g_t * (chi_u - chi))

    # Divergence: + own outward faces, - the shared faces owned by the
    # west/south/below neighbors.
    return op.inv_v * (
        f_e - nb(f_e, "west") + f_n - nb(f_n, "south") + f_t - nb(f_t, "bottom")
    )


#: the 17 per-face/per-cell coefficient arrays of the operator (wet and
#: topology are not numeric streams and keep their types).
_COEF_FIELDS = (
    "ae", "s_e", "an", "s_n", "at", "s_ti", "s_tj", "g_t",
    "cz_u", "cz_d", "cx_e", "cx_w", "cy_n", "cy_s",
    "inv_de", "inv_dn", "inv_v",
)


def redi_operator_to_bf16(op: RediOperator) -> RediOperator:
    """Cast the coefficient streams to bfloat16 (mixed-precision mode).

    Halves the coefficient traffic of `redi_apply`; the coefficients are
    promoted to the tracer dtype inside the fused arithmetic, so the
    tracer math and accumulation stay f32.
    """
    return dataclasses.replace(
        op,
        **{k: getattr(op, k).astype(jnp.bfloat16) for k in _COEF_FIELDS},
    )
