"""Smoke test of the transport-operator main path on the GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # four cards: the sharded paths only

One process drives the card(s) through the public entry points on the two
grids the repo supports, ACCESS-ESM1-5 1 degree (360 x 300 x 50) and
ACCESS-OM2 0.25 degree (1440 x 1080 x 75), both tripolar and generated
from a seed (`utils.synthetic.synthetic_device_case`):

  1. device: platform, kind, count, and the card's name and power limit;
  2. 1 degree: assembly from raw transports and its invariants; 200
     explicit Euler steps for one tracer and for B = 8; the refined ideal
     age to 1e-9; water-mass fractions for R = 4 regions;
  3. 0.25 degree: assembly; 100 steps for one tracer and for B = 8; one
     preconditioner apply; compiled memory and peak device memory;
  4. every hand-written kernel against its plain reference at both widths.

Each solve's residual is recomputed in f64 with the plain
`ops.apply.apply_stencil` and held to its tolerance. Any failure raises,
so the exit code is non-zero; the last line of standard output is the JSON
result and nothing else. Without a GPU the script exits non-zero before
any work. (`tests/test_chip_smoke.py` runs the same phases on the CPU at
toy sizes, with the kernels in the Pallas interpreter.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GRIDS = {"1deg": (360, 300, 50), "quarter": (1440, 1080, 75)}


def log(*parts):
    print(*parts, flush=True)


class Phase:
    """Times a phase and names it in the traceback if it fails."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"== {self.name}: ok ({time.perf_counter() - self.t0:.1f} s)")
        else:
            log(f"== {self.name}: FAILED ({exc_type.__name__}: {exc})")
        return False


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def _err_parts(out, ref):
    import jax.numpy as jnp

    out = out.astype(jnp.float64)
    ref = ref.astype(jnp.float64)
    return jnp.max(jnp.abs(out - ref)), jnp.max(jnp.abs(ref))


def rel_err(out, ref):
    """max |out - ref| / max |ref|, reduced in f64 on the device in one
    compiled program (the 0.25-degree batches are gigabytes: no f64 copy
    is materialized and only two scalars come back)."""
    import jax

    num, den = jax.jit(_err_parts)(out, ref)
    return float(num) / max(float(den), 1e-300)


def compare(name, out, ref, tol, dtype):
    err = rel_err(out, ref)
    log(f"  {name}: max rel err {err:.3e} (tol {tol:.0e}, {dtype})")
    check(np.isfinite(err) and err <= tol, f"{name}: {err:.3e} > {tol:.0e}")


def build(grid, seed, dtype=np.float32):
    """The synthetic case and its operator, assembled from raw transports
    by the public jittable entry point."""
    import jax

    from otmb_tpu.models.transport import assemble_transport
    from otmb_tpu.utils.synthetic import synthetic_device_case

    nx, ny, nz = grid
    gm, wet, umo, vmo, mlotst = synthetic_device_case(nx, ny, nz, seed=seed,
                                                      dtype=dtype)
    assemble = jax.jit(lambda u, v, m, g, w: assemble_transport(u, v, m, g,
                                                                w).T)
    T = jax.block_until_ready(assemble(umo, vmo, mlotst, gm, wet))
    return gm, wet, T, (umo, vmo, mlotst)


def f64(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: a.astype(np.float64), tree)


def residual_f64(T, x, b, extra, topo):
    """||(extra + T) x - b|| / ||b|| in f64 with the plain apply."""
    import jax.numpy as jnp

    from otmb_tpu.ops.apply import apply_stencil

    x = jnp.asarray(x, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    r = jnp.asarray(extra, jnp.float64) * x + apply_stencil(f64(T), x, topo) - b
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(b))


def stable_dt(T):
    return 0.5 / float(np.abs(np.asarray(T.diag)).max())


def tracer(wet, key_seed):
    import jax
    import jax.numpy as jnp

    noise = jax.random.normal(jax.random.PRNGKey(key_seed), wet.shape,
                              jnp.float32)
    return jnp.where(wet, 1.0 + 0.1 * noise, 0.0)


def propagate_checks(T, gm, wet, topo, nsteps, check_f64):
    """One tracer (XLA's step) and B = 8 (the batched kernel) through
    `explicit_euler_propagate`; conservation, batch consistency, and an
    f64 plain-path reference when `check_f64`."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import explicit_euler_propagate

    dt = stable_dt(T)
    chi0 = tracer(wet, 1)
    v = jnp.where(wet, gm.v3d, 0.0).astype(jnp.float64)
    one = jax.block_until_ready(
        explicit_euler_propagate(T, chi0, dt, nsteps, topo))
    check(one.shape == chi0.shape and bool(jnp.isfinite(one).all()),
          "single-tracer propagation not finite")
    m0 = float(jnp.sum(chi0 * v))
    drift = abs(float(jnp.sum(one * v)) - m0) / abs(m0)
    log(f"  1 tracer, {nsteps} steps (dt {dt:.1f} s): mass drift "
        f"{drift:.2e} (tol 1e-5, f32)")
    check(drift <= 1e-5, "single-tracer mass drift")
    if check_f64:
        ref = explicit_euler_propagate(f64(T), chi0.astype(jnp.float64), dt,
                                       nsteps, topo)
        compare("1 tracer vs f64 plain path", one, ref, 1e-4, "f32")

    # powers of two scale exactly, so member b is 2**b times the single
    # tracer up to the kernel's own rounding
    scale = (2.0 ** jnp.arange(8, dtype=jnp.float32))[:, None, None, None]
    chis = chi0[None] * scale
    many = jax.block_until_ready(
        explicit_euler_propagate(T, chis, dt, nsteps, topo))
    check(many.shape == chis.shape and bool(jnp.isfinite(many).all()),
          "batched propagation not finite")
    compare(f"B=8, {nsteps} steps vs 1-tracer path (scaled)", many,
            one[None] * scale, 2e-5, "f32")
    return one


def phase_1deg(grid, tol_age):
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import ideal_age, water_mass_fractions
    from otmb_tpu.ops.apply import operator_diagnostics

    with Phase("1 degree: assembly and invariants"):
        # The invariants in f64 (volume conservation is roundoff-limited,
        # so an f32 operator only shows f32 rounding); the solves below
        # take the f32 operator, the card's production precision.
        gm, wet, T64, _ = build(grid, seed=0, dtype=np.float64)
        topo = gm.topology
        d = np.asarray(T64.diag)
        w = np.asarray(wet)
        check(bool((d[w] > 0).all()), "diag > 0 on wet cells")
        for leg in ("east", "west", "north", "south", "top", "bottom"):
            check(bool((np.asarray(getattr(T64, leg)) <= 0).all()),
                  f"off-diagonal {leg} <= 0")
        diag = operator_diagnostics(T64, gm.v3d, wet, topo)
        yr = 365.25 * 86400.0
        tau_vol = float(diag["tau_vol_s"]) / yr
        log(f"  diag > 0, off-diagonals <= 0; tau_vol {tau_vol:.3e} yr "
            f"(limit > 1e9 yr, f64)")
        check(tau_vol > 1e9, "tau_vol")
        del T64
        gm, wet, T, _ = build(grid, seed=0)

    with Phase("1 degree: 200 Euler steps, 1 tracer and B=8"):
        propagate_checks(T, gm, wet, topo, 200, check_f64=True)

    surf = jnp.where(wet, jnp.zeros(wet.shape).at[0].set(1.0), 0.0)
    with Phase("1 degree: refined ideal age"):
        stats = {}
        age, res = ideal_age(T, wet, topo, tol=tol_age, apply_impl="pallas",
                             refine=True, stats=stats)
        gamma = jnp.where(wet, age, 0.0)
        rel = residual_f64(T, gamma, jnp.where(wet, 1.0, 0.0), surf, topo)
        mean_yr = float(jnp.nanmean(age)) / (365.25 * 86400.0)
        log(f"  refinements {stats.get('refinements')}, solver residual "
            f"{float(res):.3e}, f64 residual {rel:.3e} (tol {tol_age:.0e}), "
            f"mean age {mean_yr:.1f} yr")
        check(rel <= tol_age, "ideal age residual")

    with Phase("1 degree: water-mass fractions, R=4"):
        ny, nx = wet.shape[1:]
        masks = np.zeros((4, ny, nx), bool)
        for r in range(4):
            masks[r, r * ny // 4:(r + 1) * ny // 4] = True
        fr, res = water_mass_fractions(T, wet, topo, masks, tol=1e-6)
        fr = jax.block_until_ready(fr)
        check(fr.shape == (4,) + wet.shape, "fractions shape")
        worst = 0.0
        for r in range(4):
            b = jnp.where(wet & masks[r][None], surf, 0.0)
            worst = max(worst, residual_f64(
                T, jnp.where(wet, fr[r], 0.0), b, surf, topo))
        total = np.nansum(np.asarray(fr, np.float64), axis=0)[np.asarray(wet)]
        log(f"  solver residuals {np.asarray(res)}, worst f64 residual "
            f"{worst:.3e} (tol 1e-5); sum of fractions in "
            f"[{total.min():.4f}, {total.max():.4f}]")
        check(worst <= 1e-5, "fractions residual")
    return gm, wet, T


def kernel_checks(name, T, wet, topo, route):
    """Each hand-written kernel against its plain reference."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.ops.stencil_pallas import (
        apply_stencil_pallas_multi,
        euler_step_pallas_multi,
    )
    from otmb_tpu.ops.tridiag_pallas import tridiag_solve

    chi = tracer(wet, 2)
    guarded = jnp.where(T.diag != 0, T.diag, 1.0)
    thomas = jax.jit(tridiag_solve, static_argnums=4)
    for b in (chi, jnp.stack([chi, 2.0 * chi])):
        compare(f"{name} Thomas kernel, b {b.shape[:-3] or '1'} field(s), "
                f"vs scan",
                thomas(T.bottom, guarded, T.top, b, route),
                thomas(T.bottom, guarded, T.top, b, "jnp"), 1e-5, "f32")
    apply = jax.jit(apply_stencil_pallas_multi, static_argnums=(2, 3))
    step = jax.jit(euler_step_pallas_multi, static_argnums=(3, 4))
    dt = stable_dt(T)
    for nb in (1, 8):
        chis = chi[None] * (1.0 + 0.1 * jnp.arange(nb, dtype=jnp.float32)
                            )[:, None, None, None]
        compare(f"{name} batched stencil apply, B={nb}, vs apply_stencil",
                apply(T, chis, topo, route), apply(T, chis, topo, "jnp"),
                1e-5, "f32")
        compare(f"{name} batched Euler step, B={nb}, vs plain step",
                step(T, chis, dt, topo, route), step(T, chis, dt, topo, "jnp"),
                1e-6, "f32")
        del chis


def phase_quarter(grid, route):
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import (
        _tridiag_preconditioner,
        explicit_euler_propagate,
    )

    with Phase("0.25 degree: assembly"):
        gm, wet, T, raw = build(grid, seed=1)
        topo = gm.topology
        del raw
        check(all(bool(jnp.isfinite(a).all()) for a in T), "T finite")

    with Phase("0.25 degree: 100 Euler steps, 1 tracer and B=8"):
        propagate_checks(T, gm, wet, topo, 100, check_f64=False)
        step = explicit_euler_propagate.lower(
            T, tracer(wet, 1)[None].repeat(8, 0), stable_dt(T), 100, topo
        ).compile()
        log(f"  compiled B=8 propagation: {step.memory_analysis()}")

    with Phase("0.25 degree: preconditioner apply"):
        M = jax.jit(lambda c, d, b: _tridiag_preconditioner(c, d, route)(b))
        M_ref = jax.jit(lambda c, d, b: _tridiag_preconditioner(c, d, "jnp")(b))
        b = tracer(wet, 3)
        compare("0.25 degree Thomas preconditioner vs scan", M(T, T.diag, b),
                M_ref(T, T.diag, b), 1e-5, "f32")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak device memory: {stats.get('peak_bytes_in_use', 0) / 2**30:.2f}"
        f" GiB")
    return gm, wet, T


def run_one_card(grids, route, tol_age):
    """Phases 2-4 on `grids`; `route` is where the kernel checks run
    (`"gpu"` on the card)."""
    import jax

    gm, wet, T = phase_1deg(grids["1deg"], tol_age)
    with Phase("kernels vs references, 1 degree"):
        kernel_checks("1 degree", T, wet, gm.topology, route)
    del gm, wet, T
    gm, wet, T = phase_quarter(grids["quarter"], route)
    with Phase("kernels vs references, 0.25 degree"):
        kernel_checks("0.25 degree", T, wet, gm.topology, route)
    jax.block_until_ready(T)


def run_four_cards(grids):
    """The sharded paths on a (4, 1) mesh against the same computation on
    card 0: assembly and 100 propagation steps at 0.25 degree, the
    refined ideal age at 1 degree."""
    import jax
    import jax.numpy as jnp

    from otmb_tpu.models.solvers import explicit_euler_propagate, ideal_age
    from otmb_tpu.parallel.assemble import assemble_T_sharded
    from otmb_tpu.parallel.halo import euler_propagate_halo
    from otmb_tpu.parallel.mesh import make_grid_mesh, shard_pytree
    from otmb_tpu.utils.profiling import best_time

    devs = jax.devices()
    check(len(devs) >= 4, f"--cards 4 needs four devices, found {len(devs)}")
    mesh = make_grid_mesh(devs[:4], mesh_shape=(4, 1))
    four = set(devs[:4])

    def on_mesh(x, what):
        check(set(x.sharding.device_set) == four,
              f"{what} is not spread over the four cards")
        shapes = {s.data.shape for s in x.addressable_shards}
        check(len(shapes) == 1, f"{what} shards differ in shape: {shapes}")
        return shapes.pop()

    with Phase("4 cards: 0.25 degree sharded assembly"):
        gm, wet, T, (umo, vmo, mlotst) = build(grids["quarter"], seed=1)
        topo = gm.topology
        T_sh = assemble_T_sharded(umo, vmo, mlotst, gm, mesh, wet3d=wet)
        shard = on_mesh(T_sh.diag, "T")
        log(f"  shard shape {shard} on mesh {dict(mesh.shape)}")
        worst = max(rel_err(a, b) for a, b in zip(T_sh, T))
        log(f"  sharded vs card 0: max rel err {worst:.3e} over the 7 legs "
            f"(tol 1e-6, f32)")
        check(worst <= 1e-6, "sharded assembly")

    with Phase("4 cards: 0.25 degree, 100 sharded Euler steps"):
        dt = np.float32(stable_dt(T))
        chi = tracer(wet, 1)
        chi_sh = shard_pytree(mesh, chi)
        sharded = jax.jit(euler_propagate_halo, static_argnums=(3, 4, 5))
        single = jax.jit(explicit_euler_propagate, static_argnums=(3, 4))
        out = sharded(T_sh, chi_sh, dt, 100, topo, mesh)
        on_mesh(out, "propagated tracer")
        ref = single(T, chi, dt, 100, topo)
        compare("sharded propagation vs card 0", out, ref, 1e-5, "f32")
        t4 = best_time(sharded, T_sh, chi_sh, dt, 100, topo, mesh) / 100
        t1 = best_time(single, T, chi, dt, 100, topo) / 100
        log(f"  wall per step after compile: 4 cards {t4 * 1e6:.1f} us, "
            f"card 0 alone {t1 * 1e6:.1f} us")
        del T_sh, out, ref, T, gm, wet

    with Phase("4 cards: 1 degree sharded refined ideal age"):
        gm, wet, T, _ = build(grids["1deg"], seed=0)
        topo = gm.topology
        T_sh, wet_sh = shard_pytree(mesh, (T, wet))
        age_sh, res_sh = ideal_age(T_sh, wet_sh, topo, tol=1e-9,
                                   apply_impl="pallas", refine=True,
                                   mesh=mesh)
        on_mesh(age_sh, "age")
        age, res = ideal_age(T, wet, topo, tol=1e-9, apply_impl="pallas",
                             refine=True)
        log(f"  residuals: sharded {float(res_sh):.3e}, card 0 "
            f"{float(res):.3e} (tol 1e-9)")
        check(float(res_sh) <= 1e-9 and float(res) <= 1e-9, "age residual")
        w = np.asarray(wet)
        compare("sharded ideal age vs card 0", np.asarray(age_sh)[w],
                np.asarray(age)[w], 1e-5, "f64 refined")
    for d in devs[:4]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        log(f"  {d}: peak {peak / 2**30:.2f} GiB")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args()

    import jax

    from otmb_tpu.utils.profiling import (
        device_info,
        enable_compile_cache,
        gpu_name_power,
    )

    info = device_info()
    log(f"device: platform {info['platform']}, kind {info['kind']}, "
        f"count {info['count']}")
    if info["platform"] != "gpu":
        print(f"no GPU: JAX's first device is {info['platform']!r}",
              file=sys.stderr)
        return 1
    log(f"card: {gpu_name_power()}")
    log(f"compile cache: {enable_compile_cache(ROOT)}")
    jax.config.update("jax_enable_x64", True)

    t0 = time.perf_counter()
    if args.cards == 4:
        run_four_cards(GRIDS)
    else:
        run_one_card(GRIDS, "gpu", tol_age=1e-9)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
