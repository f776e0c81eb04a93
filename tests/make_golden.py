"""Regenerate tests/data/golden_tile.npz — the frozen regression golden.

The reference's CI validates against real ACCESS-ESM1-5 output
(test/online.jl:19-65); this environment has no network and no Julia
runtime, so the golden here is generated from THIS pipeline at a point
where every stage is oracle-validated (tests/reference_oracle.py is a
literal numpy re-implementation of the reference's per-cell loops) — the
golden is therefore transitively reference-validated, and `test_golden.py`
catches any future semantic drift in the full L1→L7 chain (metrics →
fluxes → operator → ideal age), per topology.

Run only when a deliberate, understood semantics change requires it:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_golden.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import otmb_tpu as otmb
from otmb_tpu.models.solvers import ideal_age
from otmb_tpu.utils.sparse_export import coeffs_to_scipy


def build(topology: str):
    ds = otmb.synthetic_dataset(nx=18, ny=14, nz=6, topology=topology, seed=3)
    gm = otmb.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices,
        lat_vertices=ds.lat_vertices,
    )
    idx = otmb.makeindices(gm.v3d)
    phi = otmb.facefluxesfrommasstransport(
        umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx
    )
    ops = otmb.transportmatrix(
        phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx
    )
    T = coeffs_to_scipy(ops.T, idx, gm.topology).tocoo()
    order = np.lexsort((T.col, T.row))
    age, res = ideal_age(ops.T, idx.wet3d, gm.topology, tol=1e-12)
    assert float(res) < 1e-10
    wet = np.asarray(idx.wet3d)
    return {
        f"{topology}_rows": T.row[order].astype(np.int32),
        f"{topology}_cols": T.col[order].astype(np.int32),
        f"{topology}_vals": np.asarray(T.data[order], np.float64),
        f"{topology}_age_wet": np.asarray(age)[wet].astype(np.float64),
    }


def main():
    out = {}
    for topology in ("tripolar", "bipolar"):
        out.update(build(topology))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "golden_tile.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    print(f"wrote {path}: " + ", ".join(
        f"{k}[{v.shape[0]}]" for k, v in sorted(out.items())
    ))


if __name__ == "__main__":
    main()
