"""Measurement harness for the card: device identity, published peaks,
measured ceilings, timing, and kernel times from a profiler trace.

The reference's only tooling is commented @profview hooks
(test/interactive.jl:121-122). Here:

  * `DEVICE_PEAKS` / `device_peaks` — published peaks keyed by JAX's
    `device_kind`; an unknown device is an error, never a default;
  * `device_info`, `gpu_name_power`, `require_gpu` — what every
    measurement line names, and the refusal to measure without a card;
  * `enable_compile_cache` — the one persistent compile-cache location;
  * `chained_step_time`, `best_time` — host-clock timing that ends in
    `block_until_ready`;
  * `ceiling_probe` — a large copy and a large bf16 matmul, the measured
    ceilings a kernel's rate is read against;
  * `trace_device`, `busy_us` — device busy time and on-device op
    durations from a jax.profiler trace.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time

import jax
import jax.numpy as jnp

#: Published dense peaks by `jax.devices()[0].device_kind`. Source:
#: NVIDIA H100 SXM data sheet (dense rates, no sparsity), which assumes
#: the full 700 W power limit; a card set lower cannot hold its top clock
#: under load, so every reported share names the card's power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "bf16_tflops": 989.0,
        "f32_tflops": 67.0,
        "source": "NVIDIA H100 SXM data sheet, dense, 700 W",
    },
}


def device_peaks(kind: str) -> dict:
    """The published peaks of `kind`; unknown devices raise KeyError."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}; add it to "
            "otmb_tpu.utils.profiling.DEVICE_PEAKS with its source"
        ) from None


def device_info() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_power() -> str:
    """`name, power.limit` of each card, as nvidia-smi prints them (a
    subprocess that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """`device_info()`, or RuntimeError when JAX finds no GPU: a
    measurement never falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {info['platform']!r}"
        )
    return info


def enable_compile_cache(root) -> str:
    """Point JAX's persistent compile cache at one fixed place and return
    it: `JAX_COMPILATION_CACHE_DIR` when set (JAX reads it itself), else
    `<root>/.jax_cache`. The path is part of the cache key, so it never
    depends on a temp directory, a pid or the time."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def best_time(fn, *args, repeats: int = 3) -> float:
    """Best wall time of `fn(*args)` after one warm-up call (which
    compiles), each call ended by `block_until_ready`."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def chained_step_time(step_fn, x0, nsteps: int = 100, repeats: int = 3) -> float:
    """Best per-step wall time of `x -> step_fn(x)` iterated `nsteps`
    times inside one jit (one dispatch, so launch gaps between calls do
    not count)."""

    @jax.jit
    def many(c):
        return jax.lax.fori_loop(0, nsteps, lambda i, v: step_fn(v), c)

    return best_time(many, x0, repeats=repeats) / nsteps


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    seconds_per_step: float
    steps_per_second: float
    bytes_per_step: int
    achieved_gbps: float
    peak_gbps: float | None
    fraction_of_peak: float | None

    def __str__(self) -> str:
        frac = (
            f" ({100 * self.fraction_of_peak:.1f}% of {self.peak_gbps:.0f} GB/s peak)"
            if self.fraction_of_peak is not None
            else ""
        )
        return (
            f"{self.seconds_per_step * 1e6:.1f} us/step, "
            f"{self.steps_per_second:.1f} steps/s, "
            f"{self.achieved_gbps:.1f} GB/s{frac}"
        )


def roofline_report(step_fn, x0, bytes_per_step: int, nsteps: int = 100,
                    kind: str | None = None) -> RooflineReport:
    """Measure `step_fn` and relate its bytes/s to the published HBM peak
    of device `kind` (no share when `kind` is None)."""
    t = chained_step_time(step_fn, x0, nsteps=nsteps)
    gbps = bytes_per_step / t / 1e9
    peak = device_peaks(kind)["hbm_gbps"] if kind is not None else None
    return RooflineReport(
        seconds_per_step=t,
        steps_per_second=1.0 / t,
        bytes_per_step=bytes_per_step,
        achieved_gbps=gbps,
        peak_gbps=peak,
        fraction_of_peak=(gbps / peak) if peak else None,
    )


def stencil_bytes(shape3d, dtype_bytes: int = 4, streams: int = 9) -> int:
    """HBM bytes per 7-point Euler step: 7 coefficient reads, one tracer
    read, one write."""
    nz, ny, nx = shape3d
    return streams * nz * ny * nx * dtype_bytes


def ceiling_probe(copy_mbytes: int = 2048, matmul_n: int = 8192) -> dict:
    """Measured ceilings in one call: a large f32 copy (bytes read plus
    bytes written per second) and a large bf16 matmul with f32
    accumulation (dense FLOP/s)."""
    n = copy_mbytes * 1024 * 1024 // 4
    x = jnp.arange(n, dtype=jnp.float32)
    copy = jax.jit(lambda a: a * 1.0000001)
    t_copy = best_time(copy, x)
    a = jax.random.normal(jax.random.PRNGKey(0), (matmul_n, matmul_n),
                          jnp.bfloat16)
    mm = jax.jit(lambda p, q: jnp.dot(p, q,
                                      preferred_element_type=jnp.float32))
    t_mm = best_time(mm, a, a)
    return {"copy_gbps": 2 * n * 4 / t_copy / 1e9,
            "bf16_tflops": 2 * matmul_n ** 3 / t_mm / 1e12}


def _device_events(logdir: str) -> list:
    """Complete events on device tracks (processes named ``/device...``)
    of the newest Chrome-trace JSON under `logdir`."""
    import glob
    import gzip
    import json

    paths = sorted(
        glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                  recursive=True)
    )
    if not paths:
        raise RuntimeError(f"no trace.json.gz produced under {logdir}")
    with gzip.open(paths[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    pid_names = {
        e["pid"]: e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    return [e for e in events
            if e.get("ph") == "X" and "dur" in e
            and str(pid_names.get(e["pid"], "")).startswith("/device")]


def busy_us(events) -> float:
    """Device busy time: the union of the events' [ts, ts + dur)
    intervals, in microseconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def trace_device(thunk, logdir: str, reps: int = 5):
    """Run `thunk` once to compile, then `reps` times under a profiler
    trace. Returns (device busy us per call, {op name: total us per call})
    from the device tracks."""
    import collections

    jax.block_until_ready(thunk())
    jax.profiler.start_trace(logdir)
    try:
        for _ in range(reps):
            jax.block_until_ready(thunk())
    finally:
        jax.profiler.stop_trace()
    events = _device_events(logdir)
    ops = collections.Counter()
    for e in events:
        ops[e["name"]] += e["dur"] / reps
    return busy_us(events) / reps, dict(ops)
