"""Command-line interface: build, validate, and use transport operators.

    python -m otmb_tpu demo                      # synthetic end-to-end run
    python -m otmb_tpu build  in.npz  op.npz     # raw fields -> operator
    python -m otmb_tpu diagnose op.npz           # conservation/sign report
    python -m otmb_tpu idealage op.npz age.npz   # steady ideal-age solve
    python -m otmb_tpu fractions op.npz f.npz --bands 3
                                                 # water-mass fractions

`in.npz` carries the canonical-layout arrays: areacello (ny,nx), volcello
(nz,ny,nx), lon, lat (ny,nx), lev (nz,), lon_vertices, lat_vertices
(4,ny,nx), umo, vmo (nz,ny,nx), mlotst (ny,nx) — see utils/io.py for
conversion from CMIP xarray datasets or reference-order arrays.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load_fields(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def cmd_demo(args) -> int:
    from examples import end_to_end  # pragma: no cover - thin alias

    end_to_end.main()
    return 0


def _build(fields):
    import otmb_tpu as otmb

    gm = otmb.makegridmetrics(
        areacello=fields["areacello"], volcello=fields["volcello"],
        lon=fields["lon"], lat=fields["lat"], lev=fields["lev"],
        lon_vertices=fields["lon_vertices"], lat_vertices=fields["lat_vertices"],
    )
    idx = otmb.makeindices(gm.v3d)
    phi = otmb.facefluxesfrommasstransport(
        umo=fields["umo"], vmo=fields["vmo"], gridmetrics=gm, indices=idx
    )
    ops = otmb.transportmatrix(
        phi=phi, mlotst=fields["mlotst"], gridmetrics=gm, indices=idx
    )
    return gm, idx, ops


def cmd_build(args) -> int:
    import otmb_tpu as otmb
    from otmb_tpu.utils.checkpoint import save_operator

    fields = _load_fields(args.input)
    gm, idx, ops = _build(fields)
    save_operator(args.output, ops.T, gm.topology,
                  v3d=np.asarray(gm.v3d), wet3d=np.asarray(idx.wet3d))
    print(f"built operator: {gm.topology.kind} grid {gm.shape}, "
          f"{idx.nwet} wet cells -> {args.output}")
    val = otmb.validate_operator(ops.T, gm.v3d, idx.wet3d, gm.topology)
    print(f"validation: upwind_ok={val.ok_upwind} "
          f"tau_vol={val.tau_vol_s/3.156e13:.3g} Myr")
    return 0 if val.ok_upwind else 1


def _load_op(path):
    from otmb_tpu.utils.checkpoint import load_operator

    coeffs, topo, extras = load_operator(path)
    if "v3d" not in extras or "wet3d" not in extras:
        raise SystemExit("operator file lacks v3d/wet3d (rebuild with `build`)")
    return coeffs, topo, extras["v3d"], extras["wet3d"].astype(bool)


def cmd_diagnose(args) -> int:
    import otmb_tpu as otmb

    coeffs, topo, v3d, wet = _load_op(args.operator)
    val = otmb.validate_operator(coeffs, v3d, wet, topo)
    myr = 1e6 * 365.25 * 24 * 3600
    print(f"grid: {topo.kind} {topo.shape3d}, wet cells {int(wet.sum())}")
    print(f"finite={val.finite} diag>0={val.diag_positive} "
          f"offdiag<=0={val.offdiag_nonpositive} land_zero={val.land_zero}")
    print(f"tau_div={val.tau_div_s/myr:.3g} Myr  tau_vol={val.tau_vol_s/myr:.3g} Myr")
    return 0 if val.finite and val.land_zero else 1


def cmd_idealage(args) -> int:
    from otmb_tpu.models.solvers import ideal_age, sequestration_time
    from otmb_tpu.utils.checkpoint import save_state

    if args.refine:
        import jax

        jax.config.update("jax_enable_x64", True)
    coeffs, topo, v3d, wet = _load_op(args.operator)
    solve = sequestration_time if args.adjoint else ideal_age
    gamma, res = solve(coeffs, wet, topo, tol=args.tol, refine=args.refine,
                       apply_impl=args.apply_impl)
    gamma = np.asarray(gamma)
    yr = 365.25 * 24 * 3600
    v = np.asarray(v3d)[wet]
    mean_age = float((gamma[wet] * v).sum() / v.sum()) / yr
    print(f"ideal age solved: residual {float(res):.2e}, "
          f"volume-weighted mean {mean_age:.1f} yr")
    save_state(args.output, ideal_age_seconds=gamma)
    print(f"saved -> {args.output}")
    return 0 if float(res) < 1e-6 else 1


def cmd_fractions(args) -> int:
    """Surface-origin water-mass fractions for latitude bands, solved as
    one batched lockstep Krylov (models/solvers.water_mass_fractions)."""
    from otmb_tpu.models.solvers import water_mass_fractions
    from otmb_tpu.utils.checkpoint import save_state

    coeffs, topo, v3d, wet = _load_op(args.operator)
    ny, nx = topo.shape3d[1:]
    edges = np.linspace(0, ny, args.bands + 1).astype(int)
    j = np.arange(ny)[:, None]
    masks = np.stack([
        np.broadcast_to((j >= lo) & (j < hi), (ny, nx))
        for lo, hi in zip(edges[:-1], edges[1:])
    ])
    fr, res = water_mass_fractions(coeffs, wet, topo, masks, tol=args.tol)
    fr = np.asarray(fr)
    v = np.nan_to_num(np.asarray(v3d))
    for r in range(args.bands):
        share = float((np.nan_to_num(fr[r]) * v).sum() / v.sum())
        print(f"band {r} (rows {edges[r]}..{edges[r+1]-1}): "
              f"{100*share:5.1f} % of ocean volume, "
              f"residual {float(res[r]):.1e}")
    save_state(args.output, fractions=fr, band_edges=np.asarray(edges))
    print(f"saved -> {args.output}")
    return 0 if float(np.asarray(res).max()) < 1e-6 else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="otmb_tpu", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("demo", help="synthetic end-to-end run").set_defaults(
        fn=cmd_demo
    )

    p = sub.add_parser("build", help="raw fields npz -> operator npz")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("diagnose", help="validate a saved operator")
    p.add_argument("operator")
    p.set_defaults(fn=cmd_diagnose)

    p = sub.add_parser("idealage", help="steady ideal-age solve")
    p.add_argument("operator")
    p.add_argument("output")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision iterative refinement (f32 Krylov + "
                        "f64 defect correction; needed for tight tolerances "
                        "with an f32 operator)")
    p.add_argument("--adjoint", action="store_true",
                   help="solve sequestration time (T' + M) instead")
    p.add_argument("--apply-impl", choices=["jnp", "pallas"], default="jnp",
                   dest="apply_impl",
                   help="jnp (plain path, GSPMD-shardable) or pallas (the "
                        "GPU kernel route: Thomas preconditioner kernel, "
                        "chunked BiCGStab(2) on large grids)")
    p.set_defaults(fn=cmd_idealage)

    p = sub.add_parser("fractions",
                       help="surface-origin water-mass fractions "
                            "(batched solve)")
    p.add_argument("operator")
    p.add_argument("output")
    p.add_argument("--bands", type=int, default=3,
                   help="number of equal latitude bands partitioning the "
                        "surface")
    p.add_argument("--tol", type=float, default=1e-8)
    p.set_defaults(fn=cmd_fractions)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
