"""Test configuration: CPU backend with 8 virtual devices and float64.

Must run before jax initializes its backend, hence the env manipulation at
import time. Float64 is required to reproduce the reference's Myr-scale
conservation diagnostics (the reference deliberately densifies to Float64,
velocities.jl:124-126).

The suite runs on the CPU unless the command names the GPU
(`JAX_PLATFORMS=cuda python -m pytest tests/ -m chip` on the card); tests
marked `chip` need the card and skip elsewhere (see the `gpu` fixture).
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") not in ("cuda", "gpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from otmb_tpu.grid.geometry import makegridmetrics
from otmb_tpu.grid.indices import makeindices
from otmb_tpu.utils.synthetic import synthetic_dataset


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU. Decided here, at test
    time, never at import: every xdist worker must collect the same
    tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")
    return jax.devices()[0]


@pytest.fixture(scope="session", params=["bipolar", "tripolar"])
def topology_kind(request):
    return request.param


@pytest.fixture(scope="session")
def dataset(topology_kind):
    return synthetic_dataset(nx=18, ny=14, nz=6, topology=topology_kind, seed=3)


@pytest.fixture(scope="session")
def gridmetrics(dataset):
    ds = dataset
    return makegridmetrics(
        areacello=ds.areacello,
        volcello=ds.volcello,
        lon=ds.lon,
        lat=ds.lat,
        lev=ds.lev,
        lon_vertices=ds.lon_vertices,
        lat_vertices=ds.lat_vertices,
    )


@pytest.fixture(scope="session")
def indices(gridmetrics):
    return makeindices(gridmetrics.v3d)
