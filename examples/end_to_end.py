"""End-to-end demo: CMIP-style fields -> transport operator -> workloads.

Runs anywhere (CPU or GPU). On CPU, enable float64 for Myr-scale
conservation diagnostics:

    JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu python examples/end_to_end.py
"""

import numpy as np
import jax

import otmb_tpu as otmb

YR = 365.25 * 24 * 3600
MYR = 1e6 * YR


def main():
    # 1. Data. Real use: otmb_tpu.utils.io.gridmetrics_from_xarray /
    # transports_from_xarray over CMIP NetCDF/Zarr; here, synthetic.
    ds = otmb.synthetic_dataset(nx=48, ny=32, nz=12, topology="tripolar", seed=0)

    # 2. Grid metrics, wet indices, six-face fluxes, operator.
    gm = otmb.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices)
    idx = otmb.makeindices(gm.v3d)
    phi = otmb.facefluxesfrommasstransport(
        umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    ops = otmb.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm,
                               indices=idx)
    print(f"grid {gm.topology.kind} {gm.shape}, wet cells {idx.nwet}")

    # 3. Conservation diagnostics (the reference's de-facto spec).
    for name in ("Tadv", "TkH", "TkVML", "TkVdeep"):
        d = otmb.operator_diagnostics(getattr(ops, name), gm.v3d, idx.wet3d,
                                      gm.topology)
        print(f"  {name:8s} tau_div {float(d['tau_div_s'])/MYR:10.3g} Myr   "
              f"tau_vol {float(d['tau_vol_s'])/MYR:10.3g} Myr")

    # 4. Tracer propagation (explicit, CFL-stable step).
    wet = np.asarray(idx.wet3d)
    dt = 0.25 / float(np.abs(np.asarray(ops.T.diag)).max())
    chi = np.where(wet, 1.0, 0.0)
    chi = np.asarray(otmb.explicit_euler_propagate(ops.T, chi, dt, 100,
                                                   gm.topology))
    v = np.where(wet, np.asarray(gm.v3d), 0.0)
    print(f"100 explicit steps (dt={dt:.0f}s): tracer range "
          f"[{chi[wet].min():.3f}, {chi[wet].max():.3f}]")

    # 5. Ideal age and sequestration time, matrix-free on device.
    age, _ = otmb.ideal_age(ops.T, idx.wet3d, gm.topology)
    seq, _ = otmb.sequestration_time(ops.T, idx.wet3d, gm.topology)
    vw = np.asarray(gm.v3d)[wet]
    print(f"ideal age {float((np.asarray(age)[wet]*vw).sum()/vw.sum())/YR:.2f} yr, "
          f"sequestration {float((np.asarray(seq)[wet]*vw).sum()/vw.sum())/YR:.2f} yr")

    # 6. Coarsen and export for host tools.
    mat = otmb.coeffs_to_scipy(ops.T, idx, gm.topology)
    from otmb_tpu.grid.indices import wet_vector
    lump, spray, v_c = otmb.lump_and_spray(
        wet, wet_vector(np.asarray(gm.v3d), idx), mat, di=2, dj=2)
    print(f"coarsened {lump.shape[1]} -> {lump.shape[0]} cells")

    # 7. Multi-device (works on any jax.devices(); on CPU set
    # XLA_FLAGS=--xla_force_host_platform_device_count=8).
    if len(jax.devices()) > 1:
        from otmb_tpu.parallel.halo import euler_propagate_halo
        from otmb_tpu.parallel.mesh import make_grid_mesh, shard_pytree, sharding_for

        mesh = make_grid_mesh()
        coeffs = shard_pytree(mesh, ops.T)
        chi_sh = jax.device_put(np.where(wet, 1.0, 0.0),
                                sharding_for(mesh, chi))
        out = euler_propagate_halo(coeffs, chi_sh, dt, 100, gm.topology, mesh)
        print(f"sharded propagation over {dict(mesh.shape)}: "
              f"max|delta| vs single-device = "
              f"{float(np.abs(np.asarray(out) - chi).max()):.3e}")


if __name__ == "__main__":
    main()
