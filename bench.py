"""Benchmark on the GPU: the card's measured ceilings, each hand-written
kernel against what XLA makes of its plain version, and the public entry
points with the kernels on and off.

    python bench.py [--grids 1deg quarter] [--sections ...] [--out PATH]

Grids: ACCESS-ESM1-5 1 degree (360 x 300 x 50) and ACCESS-OM2 0.25 degree
(1440 x 1080 x 75), tripolar, generated from a seed on the device. Every
printed line starts with the card's name and power limit; `--out` also
gets one JSON record of everything measured. Times are wall times ended
by `block_until_ready` after a warm-up call (so compilation is excluded
and reported apart), or device busy time from a jax.profiler trace where
the line says "device". Without a GPU the script fails: it never measures
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GRIDS = {"1deg": (360, 300, 50), "quarter": (1440, 1080, 75)}
SECTIONS = ("kernels", "propagation", "engines", "solves", "redi")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--grids", nargs="+", choices=sorted(GRIDS),
                        default=["1deg", "quarter"])
    parser.add_argument("--sections", nargs="+", choices=SECTIONS,
                        default=list(SECTIONS),
                        help="what to measure on each grid (the whole "
                             "solves run at 1 degree only)")
    parser.add_argument("--out", default=None,
                        help="write the JSON record here as well")
    args = parser.parse_args()

    import jax

    from otmb_tpu.utils import profiling as prof

    info = prof.require_gpu()
    card = prof.gpu_name_power()
    prof.enable_compile_cache(ROOT)
    jax.config.update("jax_enable_x64", True)
    tag = f"[{card}]"
    record = {"device": info, "card": card,
              "peaks": prof.device_peaks(info["kind"]), "grids": {}}

    def emit(msg):
        print(f"{tag} {msg}", flush=True)

    emit(f"device {info}; published peaks {record['peaks']}")
    record["ceilings"] = prof.ceiling_probe()
    emit(f"measured ceilings: copy {record['ceilings']['copy_gbps']:.1f} "
         f"GB/s, bf16 matmul {record['ceilings']['bf16_tflops']:.1f} TFLOP/s")
    for name in args.grids:
        record["grids"][name] = bench_grid(name, GRIDS[name], emit,
                                           set(args.sections))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


def bench_grid(name, grid, emit, sections):
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models import solvers as S
    from otmb_tpu.models.transport import assemble_transport
    from otmb_tpu.ops.apply import apply_stencil
    from otmb_tpu.ops.stencil_pallas import apply_stencil_pallas_multi
    from otmb_tpu.ops.tridiag_pallas import tridiag_solve
    from otmb_tpu.utils import profiling as prof
    from otmb_tpu.utils.synthetic import synthetic_device_case

    out = {}
    nx, ny, nz = grid
    cells = nx * ny * nz
    gm, wet, umo, vmo, mlotst = synthetic_device_case(nx, ny, nz, seed=0)
    topo = gm.topology

    assemble = jax.jit(lambda u, v, m, g, w: assemble_transport(u, v, m, g,
                                                                w).T)
    t0 = time.perf_counter()
    T = jax.block_until_ready(assemble(umo, vmo, mlotst, gm, wet))
    out["assembly_first_call_s"] = time.perf_counter() - t0
    out["assembly_s"] = prof.best_time(assemble, umo, vmo, mlotst, gm, wet)
    emit(f"{name}: assembly {out['assembly_s'] * 1e3:.2f} ms "
         f"({cells / out['assembly_s'] / 1e9:.3f} G cells/s; first call with "
         f"compile {out['assembly_first_call_s']:.1f} s)")
    del umo, vmo, mlotst

    key = jax.random.PRNGKey(1)
    chi = jnp.where(wet, 1.0 + 0.1 * jax.random.normal(key, wet.shape,
                                                        jnp.float32), 0.0)
    if "kernels" in sections:
        out["kernels_device_us"] = kernels(T, chi, topo, emit, name)
    if "propagation" in sections:
        out["propagation"] = propagation(T, chi, topo, grid, emit, name)
    if "engines" in sections:
        out["engines"] = engines(T, chi, topo, emit, name)
    if "solves" in sections and name == "1deg":
        out["solves"] = solves(T, wet, topo, emit, name)
    if "redi" in sections:
        out["redi_device_us"] = redi(gm, wet, chi, emit, name)
    return out


def kernels(T, chi, topo, emit, name):
    """Each kernel against XLA's plain version: device busy time per call
    from a profiler trace."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.ops.stencil_pallas import apply_stencil_pallas_multi
    from otmb_tpu.ops.tridiag_pallas import tridiag_solve
    from otmb_tpu.utils import profiling as prof

    guarded = jnp.where(T.diag != 0, T.diag, 1.0)

    thomas = jax.jit(tridiag_solve, static_argnums=4)
    apply_multi = jax.jit(apply_stencil_pallas_multi, static_argnums=(2, 3))
    cases = {"thomas": lambda r: (lambda: thomas(T.bottom, guarded, T.top,
                                                 chi, r))}
    for nb in (1, 8):
        chis = jnp.broadcast_to(chi, (nb,) + chi.shape) + 0.0
        cases[f"stencil_B{nb}"] = (
            lambda r, chis=chis: (lambda: apply_multi(T, chis, topo, r)))
    result = {}
    for case, make in cases.items():
        row = {}
        for label, route in (("kernel", "gpu"), ("xla", "jnp")):
            with tempfile.TemporaryDirectory() as logdir:
                busy, ops = prof.trace_device(make(route), logdir)
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:3]
            row[label] = {"device_us": busy,
                          "top_ops_us": {k: v for k, v in top}}
        result[case] = row
        emit(f"{name}: {case}: device {row['kernel']['device_us']:.1f} us "
             f"kernel vs {row['xla']['device_us']:.1f} us XLA "
             f"(XLA ops: {', '.join(f'{k} {v:.0f}' for k, v in row['xla']['top_ops_us'].items())})")
    return result


def propagation(T, chi, topo, grid, emit, name):
    """Explicit Euler through the public entry point: one tracer (XLA)
    and B = 8 (the batched kernel) against XLA's batched step."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models import solvers as S
    from otmb_tpu.ops.apply import apply_stencil
    from otmb_tpu.utils import profiling as prof

    dt = 0.5 / float(jnp.abs(T.diag).max())
    nsteps = 50
    prop = jax.jit(S.explicit_euler_propagate, static_argnums=(3, 4))

    @jax.jit
    def prop_xla(coeffs, c, dt_):
        step = lambda x, _: (x - dt_ * apply_stencil(coeffs, x, topo), None)
        return jax.lax.scan(step, c, None, length=nsteps)[0]

    t1 = prof.best_time(prop, T, chi, dt, nsteps, topo) / nsteps
    bytes1 = prof.stencil_bytes(grid)
    chis8 = jnp.broadcast_to(chi, (8,) + chi.shape) + 0.0
    t8k = prof.best_time(prop, T, chis8, dt, nsteps, topo) / nsteps
    t8x = prof.best_time(prop_xla, T, chis8, dt) / nsteps
    res = {"one_tracer_step_s": t1, "one_tracer_gbps": bytes1 / t1 / 1e9,
           "b8_kernel_step_s": t8k, "b8_xla_step_s": t8x}
    emit(f"{name}: Euler step, 1 tracer (XLA): {t1 * 1e6:.1f} us = "
         f"{1 / t1:.1f} steps/s, {bytes1 / t1 / 1e9:.1f} GB/s of 9 f32 "
         f"streams")
    emit(f"{name}: Euler step, B=8: kernel {t8k * 1e6:.1f} us vs XLA "
         f"{t8x * 1e6:.1f} us ({8 / t8k:.1f} vs {8 / t8x:.1f} tracer-steps/s)")
    return res


def engines(T, chi, topo, emit, name):
    """Krylov engines per matvec pair, Thomas and batched stencil kernels
    on and off (the chunk programs the large-grid engines run)."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models import solvers as S
    from otmb_tpu.utils import profiling as prof

    shifted = T.diag
    state1 = (jnp.zeros_like(chi), chi + 0.0, jnp.zeros_like(chi), chi + 0.0,
              jnp.ones((), chi.dtype), jnp.zeros((), chi.dtype),
              jnp.ones((), chi.dtype))
    ncyc = 10
    eng = {}
    for label, route in (("kernel", "gpu"), ("xla", "jnp")):
        def run(route=route):
            st = jax.tree_util.tree_map(lambda a: a + 0.0, state1)
            return S._sr_chunk2(T, T, shifted, st, ncyc, topo, "tridiag",
                                route)[1]
        eng[f"bicgstab2_{label}_s_per_pair"] = prof.best_time(run) / (2 * ncyc)
    nb = 4
    bs = jnp.broadcast_to(chi, (nb,) + chi.shape) + 0.0
    state4 = (jnp.zeros_like(bs), bs + 0.0, jnp.zeros_like(bs), bs + 0.0,
              jnp.ones((nb,), bs.dtype), jnp.zeros((nb,), bs.dtype),
              jnp.ones((nb,), bs.dtype))
    for label, route in (("kernel", "gpu"), ("xla", "jnp")):
        def run(route=route):
            st = jax.tree_util.tree_map(lambda a: a + 0.0, state4)
            return S._mr_chunk2(T, T, shifted, st, ncyc, topo, "tridiag",
                                route)[1]
        eng[f"batched_B4_{label}_s_per_pair"] = prof.best_time(run) / (2 * ncyc)
    emit(f"{name}: BiCGStab(2) per matvec pair: Thomas kernel "
         f"{eng['bicgstab2_kernel_s_per_pair'] * 1e3:.3f} ms vs scans "
         f"{eng['bicgstab2_xla_s_per_pair'] * 1e3:.3f} ms; batched B=4: "
         f"kernels {eng['batched_B4_kernel_s_per_pair'] * 1e3:.3f} ms vs XLA "
         f"{eng['batched_B4_xla_s_per_pair'] * 1e3:.3f} ms")
    return eng


def solves(T, wet, topo, emit, name):
    """Whole solves at 1 degree, kernel route vs plain path."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import ideal_age, water_mass_fractions

    res = {}
    for impl in ("pallas", "jnp"):
        times = []
        for _ in range(2):  # the first call compiles
            t0 = time.perf_counter()
            age, rel = ideal_age(T, wet, topo, tol=1e-9, apply_impl=impl,
                                 refine=True)
            jax.block_until_ready(age)
            times.append(time.perf_counter() - t0)
        res[f"ideal_age_{impl}_s"] = times[1]
        res[f"ideal_age_{impl}_rel"] = float(rel)
        emit(f"{name}: refined ideal age to 1e-9, apply_impl={impl}: "
             f"{times[1]:.3f} s (first call {times[0]:.1f} s), residual "
             f"{float(rel):.2e}")
    ny, nx = wet.shape[1:]
    masks = np.zeros((4, ny, nx), bool)
    for r in range(4):
        masks[r, r * ny // 4:(r + 1) * ny // 4] = True
    for impl in ("pallas", "jnp"):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            fr, rel = water_mass_fractions(T, wet, topo, masks, tol=1e-6,
                                           apply_impl=impl)
            jax.block_until_ready(fr)
            times.append(time.perf_counter() - t0)
        res[f"fractions_R4_{impl}_s"] = times[1]
        res[f"fractions_R4_{impl}_rel"] = float(jnp.max(rel))
        emit(f"{name}: water-mass fractions R=4 to 1e-6, apply_impl={impl}: "
             f"{times[1]:.3f} s (first call {times[0]:.1f} s), worst residual "
             f"{float(jnp.max(rel)):.2e}")
    return res


def redi(gm, wet, chi, emit, name):
    """The Redi 19-point apply (XLA's fusion of `redi_apply`), device
    time per call, f32."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models.redi import build_redi_operator, redi_apply
    from otmb_tpu.utils import profiling as prof

    z = gm.z3d
    rho = jnp.where(wet, 1025.0 + 0.02 * z
                    + 2e-4 * z * jnp.cos(2 * jnp.deg2rad(gm.lon)), jnp.nan)
    op = jax.block_until_ready(build_redi_operator(rho, gm, wet))
    with tempfile.TemporaryDirectory() as logdir:
        busy, ops = prof.trace_device(lambda: redi_apply(op, chi), logdir)
    emit(f"{name}: redi_apply (XLA): device {busy:.1f} us")
    return busy


if __name__ == "__main__":
    sys.exit(main())
