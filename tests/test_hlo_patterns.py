"""Communication-pattern regression: the sharded steady-state hot path
must lower to neighbor collective-permutes only.

The halo layer (parallel/halo.py) is written so every inter-shard
transfer is a 1-cell edge exchange via lax.ppermute — which XLA compiles
to `collective-permute` ops between neighbor devices. A GSPMD or
shard_map regression could silently replace those with `all-gather` /
`all-reduce` (full-mesh traffic, O(devices) more bytes); this test pins
the compiled-HLO communication pattern so that cannot happen unnoticed.
"""

import numpy as np
import pytest
import jax

from otmb_tpu.models.transport import transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
from otmb_tpu.parallel.halo import apply_stencil_halo, euler_propagate_halo
from otmb_tpu.parallel.mesh import make_grid_mesh, shard_pytree, sharding_for


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_grid_mesh(jax.devices()[:8])


@pytest.fixture(scope="module", params=["bipolar", "tripolar"])
def case(request, mesh):
    from otmb_tpu.grid.geometry import makegridmetrics
    from otmb_tpu.grid.indices import makeindices
    from otmb_tpu.utils.synthetic import synthetic_dataset

    ds = synthetic_dataset(nx=16, ny=8, nz=6, topology=request.param, seed=3)
    gm = makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
    )
    idx = makeindices(gm.v3d)
    phi = facefluxesfrommasstransport(
        umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx
    )
    ops = transportmatrix(
        phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx
    )
    wet = np.asarray(idx.wet3d)
    chi = np.where(wet, 1.0, 0.0)
    coeffs_sh = shard_pytree(mesh, ops.T)
    chi_sh = jax.device_put(chi, sharding_for(mesh, chi))
    return gm.topology, coeffs_sh, chi_sh


def _compiled_hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _assert_permute_only(hlo: str, what: str,
                         allow_scalar_allreduce: bool = False):
    # Accept both spellings XLA uses across versions/passes.
    assert ("collective-permute" in hlo) or ("collective_permute" in hlo), (
        f"{what}: no collective-permute in compiled HLO — halo exchange "
        "is not lowering to neighbor transfers"
    )
    bad_always = ("all-gather", "all_gather", "all-to-all", "all_to_all")
    bad_reduce = ("all-reduce", "all_reduce")
    for bad in bad_always:
        assert bad not in hlo, (
            f"{what}: compiled HLO contains {bad!r} — the steady path must "
            "use only neighbor collective-permutes"
        )
    if allow_scalar_allreduce:
        # Krylov dot products psum one scalar each — O(1) bytes, latency
        # only. Any all-reduce over a non-scalar shape means GSPMD turned
        # a halo exchange into full-mesh traffic; catch that.
        import re

        for line in hlo.splitlines():
            if any(b in line for b in bad_reduce) and "=" in line:
                shape = line.split("=", 1)[1].strip()
                m = re.match(r"\(?([a-z0-9]+)\[([0-9,]*)\]", shape)
                if m is not None:
                    assert m.group(2) == "", (
                        f"{what}: non-scalar all-reduce in compiled HLO "
                        f"({line.strip()[:120]}) — a halo exchange degraded "
                        "to full-mesh traffic"
                    )
    else:
        for bad in bad_reduce:
            assert bad not in hlo, (
                f"{what}: compiled HLO contains {bad!r} — the steady path "
                "must use only neighbor collective-permutes"
            )


def test_apply_hlo_is_permute_only(mesh, case):
    topo, coeffs_sh, chi_sh = case
    hlo = _compiled_hlo(
        lambda c, x: apply_stencil_halo(c, x, topo, mesh), coeffs_sh, chi_sh
    )
    _assert_permute_only(hlo, "apply_stencil_halo")


@pytest.mark.parametrize("overlap", [False, True])
def test_propagate_hlo_is_permute_only(mesh, case, overlap):
    topo, coeffs_sh, chi_sh = case
    hlo = _compiled_hlo(
        lambda c, x: euler_propagate_halo(c, x, 300.0, 10, topo, mesh,
                                          overlap=overlap),
        coeffs_sh, chi_sh,
    )
    _assert_permute_only(hlo, f"euler_propagate_halo(overlap={overlap})")


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_krylov_hlo_is_permute_only(mesh, case, overlap):
    """The whole sharded BiCGStab program: halo ppermutes for the matvec;
    all-reduces appear ONLY as scalar dot products (psum of one number) —
    never over field shapes. Pinned for both the serialized and the
    comm/compute-overlapped matvec, with the Thomas kernel interpreted."""
    from otmb_tpu.parallel.solve_halo import solve_shifted_halo

    topo, coeffs_sh, chi_sh = case
    hlo = _compiled_hlo(
        lambda c, b: solve_shifted_halo(
            c, b, topo, mesh, shift=1e-4, tol=1e-8, maxiter=50,
            interpret=True, overlap=overlap,
        )[0],
        coeffs_sh, chi_sh,
    )
    _assert_permute_only(hlo, f"solve_shifted_halo(overlap={overlap})",
                         allow_scalar_allreduce=True)


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_jacobi_krylov_hlo_is_permute_only(mesh, case, overlap):
    from otmb_tpu.parallel.solve_halo import solve_shifted_halo

    topo, coeffs_sh, chi_sh = case
    hlo = _compiled_hlo(
        lambda c, b: solve_shifted_halo(
            c, b, topo, mesh, shift=1e-4, tol=1e-8, maxiter=50,
            preconditioner="jacobi", overlap=overlap,
        )[0],
        coeffs_sh, chi_sh,
    )
    _assert_permute_only(hlo, f"jacobi solve (overlap={overlap})",
                         allow_scalar_allreduce=True)


@pytest.mark.parametrize("preconditioner", ["tridiag", "jacobi"])
@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
def test_sharded_chunked_krylov_hlo_is_permute_only(mesh, case, algorithm,
                                                    preconditioner):
    """The sharded fori-chunked Krylov engine's per-chunk program (the
    mesh path for large shards): halo ppermutes for the
    matvec, all-reduces only as scalar dot products."""
    import jax.numpy as jnp
    import otmb_tpu.parallel.solve_halo_chunked as HC

    topo, coeffs_sh, chi_sh = case
    b = jnp.asarray(chi_sh)
    if algorithm == "bicgstab":
        state = (jnp.zeros_like(b), b + 0.0, b + 0.0, b + 0.0,
                 jnp.vdot(b, b))
    else:
        state = (jnp.zeros_like(b), b + 0.0, jnp.zeros_like(b), b + 0.0,
                 jnp.ones((), b.dtype), jnp.zeros((), b.dtype),
                 jnp.ones((), b.dtype))
    lowered = HC._hc_run_chunk.lower(
        coeffs_sh, state, 10, topo, mesh, preconditioner, "interpret", True,
        algorithm
    )
    hlo = lowered.compile().as_text()
    _assert_permute_only(
        hlo, f"_hc_run_chunk({algorithm}, {preconditioner})",
        allow_scalar_allreduce=True,
    )
