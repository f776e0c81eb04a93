"""The one route choice (`ops.pallas_util.kernel_route`) and the
measurement harness (`utils.profiling`): device peaks, the compile-cache
location, and the reduction of a profiler trace to device time."""

import gzip
import json
import os

import jax
import pytest

from otmb_tpu.ops import pallas_util
from otmb_tpu.utils import profiling


@pytest.mark.parametrize("backend,route", [("gpu", "gpu"), ("cpu", "jnp")])
def test_kernel_route_by_backend(monkeypatch, backend, route):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert pallas_util.kernel_route() == route


def test_kernel_route_interpret_only_on_request(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pallas_util.kernel_route(interpret=True) == "interpret"
    assert pallas_util.kernel_route(interpret=False) == "gpu"


def test_kernel_route_unknown_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no kernel route"):
        pallas_util.kernel_route()


def test_kernel_route_in_this_process_is_plain():
    assert pallas_util.kernel_route() == "jnp"
    with pytest.raises(ValueError):
        pallas_util.check_route("mosaic")


def test_device_peaks_known_card():
    peaks = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_gbps"] == 3350.0
    assert peaks["bf16_tflops"] == 989.0
    assert "data sheet" in peaks["source"]


def test_device_peaks_unknown_card_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks("cpu")


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        profiling.require_gpu()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert profiling.enable_compile_cache("/anywhere") == str(tmp_path / "c")
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_fixed_repo_path(monkeypatch, tmp_path):
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.enable_compile_cache(str(tmp_path))
    assert path == os.path.join(str(tmp_path), ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in updates
    # the same root always gives the same directory
    assert profiling.enable_compile_cache(str(tmp_path)) == path


def _write_trace(logdir, events):
    d = os.path.join(logdir, "plugins", "profile", "run")
    os.makedirs(d)
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
    ]
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": meta + events}, f)


def test_trace_reduction_device_tracks_and_union(tmp_path):
    """Only device-track events count, and overlapping events (one op
    shown on two lines) count once."""
    _write_trace(str(tmp_path), [
        {"ph": "X", "pid": 1, "tid": 1, "name": "otmb_thomas", "ts": 0,
         "dur": 10},
        {"ph": "X", "pid": 1, "tid": 2, "name": "module", "ts": 0,
         "dur": 12},
        {"ph": "X", "pid": 1, "tid": 1, "name": "fusion", "ts": 20,
         "dur": 5},
        {"ph": "X", "pid": 2, "tid": 1, "name": "host_op", "ts": 0,
         "dur": 100},
    ])
    events = profiling._device_events(str(tmp_path))
    assert {e["name"] for e in events} == {"otmb_thomas", "module", "fusion"}
    assert profiling.busy_us(events) == 17.0


def test_trace_reduction_missing_trace_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no trace"):
        profiling._device_events(str(tmp_path))


def test_trace_device_runs_a_thunk_under_the_profiler(tmp_path):
    """The whole reduction on a real (CPU) trace: the thunk runs, a trace
    is written and parsed; the CPU has no device tracks, so no busy time."""
    import jax.numpy as jnp

    calls = []

    def thunk():
        calls.append(1)
        return jnp.arange(8.0) * 2.0

    busy, ops = profiling.trace_device(thunk, str(tmp_path), reps=2)
    assert len(calls) == 3  # one warm-up call, then the traced reps
    assert busy == 0.0 and ops == {}
