"""otmb_tpu — ocean transport-operator engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
OceanTransportMatrixBuilder.jl: ingest CMIP Arakawa C-grid mass
transports and grid metrics, close the six-face cell fluxes by mass
conservation, and assemble the advection-diffusion transport operator
T = Tadv + TkH + TkVML + TkVdeep as dense stencil coefficients applied
matrix-free on the accelerator.

Public API mirrors the reference exports
(src/OceanTransportMatrixBuilder.jl:31-36).
"""

from .config import TransportConfig
from .grid.geometry import GridMetrics, cell_thickness_from_lev_bnds, makegridmetrics
from .grid.indices import Indices, as2d, as3d, makeindices, wet_vector
from .grid.topology import GridTopology, detect_topology, shift_values
from .models.transport import (
    TransportOperators,
    buildTadv,
    buildTkH,
    buildTkVdeep,
    buildTkVML,
    transportmatrix,
)
from .models.redi import (
    RediOperator,
    build_redi_operator,
    redi_apply,
    redi_operator_to_bf16,
)
from .models.redigm import (
    add_bolus_transports,
    bolus_gm_velocity,
    density_slopes,
    potential_density_slopes,
)
from .physics.eos import linear_eos, rho_teos10, sigma0_teos10
from .models.solvers import (
    explicit_euler_propagate,
    ideal_age,
    implicit_euler_step,
    sequestration_time,
    solve_shifted_chunked_multi,
    solve_shifted_multi,
    water_mass_fractions,
)
from .models.transport import assemble_transport
from .ops.apply import (
    apply_stencil,
    apply_stencil_transpose,
    operator_diagnostics,
    transpose_coeffs,
)
from .ops.autodiff import (
    apply_stencil_ad,
    differentiable_solve,
    euler_step_ad,
)
from .ops.coeffs import StencilCoeffs, add_coeffs
from .ops.fluxes import FaceFluxes, facefluxes, facefluxesfrommasstransport
from .ops.stencil_pallas import apply_stencil_pallas_multi, euler_step_pallas_multi
from .ops.velocities import (
    facefluxesfromvelocities,
    fluxes2velocity,
    getarakawagrid,
    interpolateontodefaultCgrid,
    velocity2fluxes,
)
from .utils.coarsen import ideal_age_coarsened, lump_and_spray
from .utils.debugging import enable_nan_debugging, validate_operator
from .utils.sparse_export import coeffs_to_scipy
from .utils.synthetic import synthetic_dataset

__version__ = "0.1.0"

__all__ = [
    "TransportConfig",
    "GridMetrics",
    "makegridmetrics",
    "Indices",
    "makeindices",
    "wet_vector",
    "as2d",
    "as3d",
    "GridTopology",
    "detect_topology",
    "shift_values",
    "cell_thickness_from_lev_bnds",
    "validate_operator",
    "TransportOperators",
    "transportmatrix",
    "buildTadv",
    "buildTkH",
    "buildTkVML",
    "buildTkVdeep",
    "apply_stencil",
    "apply_stencil_transpose",
    "transpose_coeffs",
    "operator_diagnostics",
    "StencilCoeffs",
    "add_coeffs",
    "FaceFluxes",
    "facefluxes",
    "facefluxesfrommasstransport",
    "facefluxesfromvelocities",
    "velocity2fluxes",
    "fluxes2velocity",
    "getarakawagrid",
    "interpolateontodefaultCgrid",
    "apply_stencil_ad",
    "euler_step_ad",
    "differentiable_solve",
    "apply_stencil_pallas_multi",
    "euler_step_pallas_multi",
    "assemble_transport",
    "explicit_euler_propagate",
    "implicit_euler_step",
    "ideal_age",
    "sequestration_time",
    "solve_shifted_multi",
    "solve_shifted_chunked_multi",
    "water_mass_fractions",
    "bolus_gm_velocity",
    "add_bolus_transports",
    "density_slopes",
    "potential_density_slopes",
    "RediOperator",
    "build_redi_operator",
    "redi_apply",
    "redi_operator_to_bf16",
    "ideal_age_coarsened",
    "lump_and_spray",
    "coeffs_to_scipy",
    "synthetic_dataset",
    "rho_teos10",
    "sigma0_teos10",
    "linear_eos",
]
