"""The two hand-written kernels against their plain references: the
Thomas line solve (`ops/tridiag_pallas.py`) and the batched 7-point
stencil (`ops/stencil_pallas.py`). Here they run in the Pallas
interpreter; the tests marked `chip` compile them for the GPU and skip
elsewhere."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import otmb_tpu.ops.stencil_pallas as sp
import otmb_tpu.ops.tridiag_pallas as tp
from otmb_tpu.grid.topology import GridTopology
from otmb_tpu.ops import pallas_util
from otmb_tpu.ops.apply import apply_stencil, transpose_coeffs
from otmb_tpu.ops.coeffs import StencilCoeffs
from otmb_tpu.ops.tridiag_pallas import tridiag_solve, tridiag_solve_ref


def _tridiag_system(shape, dtype, seed, land_frac=0.2):
    """A diagonally dominant per-column system with land columns (unit
    diagonal, zero couplings) and a zero top/bottom coupling."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    lower = -rng.uniform(0.0, 1.0, shape)
    upper = -rng.uniform(0.0, 1.0, shape)
    lower[-1] = 0.0
    upper[0] = 0.0
    diag = 2.5 + rng.uniform(0.0, 1.0, shape)
    land = rng.uniform(size=(ny, nx)) < land_frac
    lower[:, land] = 0.0
    upper[:, land] = 0.0
    diag[:, land] = 1.0
    cast = lambda a: jnp.asarray(a, dtype)
    return cast(lower), cast(diag), cast(upper), land


# (nz, ny, nx): one partial program; columns a whole number of programs
# (2 x 128); a ragged last program (ny * nx = 130); the 1-degree depth.
SHAPES = [(5, 7, 9), (6, 16, 16), (3, 10, 13), (50, 3, 6)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_thomas_kernel_matches_scan(shape, dtype):
    lower, diag, upper, land = _tridiag_system(shape, dtype, seed=sum(shape))
    b = jnp.asarray(np.random.default_rng(1).standard_normal(shape), dtype)
    out = tridiag_solve(lower, diag, upper, b, "interpret")
    ref = tridiag_solve_ref(lower, diag, upper, b)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    # land columns pass b through unchanged (unit diagonal)
    np.testing.assert_array_equal(np.asarray(out)[:, land],
                                  np.asarray(b)[:, land])


@pytest.mark.parametrize("nb", [1, 3])
def test_thomas_kernel_batch_shares_coefficients(nb):
    """A (B, nz, ny, nx) right-hand side solves each member against the
    same coefficients, and the result satisfies the system."""
    shape = (7, 9, 15)
    lower, diag, upper, _ = _tridiag_system(shape, np.float64, seed=4)
    bs = jnp.asarray(np.random.default_rng(5).standard_normal(
        (nb,) + shape))
    out = np.asarray(tridiag_solve(lower, diag, upper, bs, "interpret"))
    for m in range(nb):
        x = out[m]
        xp = np.concatenate([np.zeros_like(x[:1]), x[:-1]])  # x[k-1]
        xn = np.concatenate([x[1:], np.zeros_like(x[:1])])  # x[k+1]
        resid = (np.asarray(upper) * xp + np.asarray(diag) * x
                 + np.asarray(lower) * xn - np.asarray(bs[m]))
        assert np.abs(resid).max() < 1e-12


def test_thomas_route_jnp_is_the_scan():
    shape = (4, 5, 6)
    lower, diag, upper, _ = _tridiag_system(shape, np.float32, seed=6)
    b = jnp.ones(shape, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(tridiag_solve(lower, diag, upper, b, "jnp")),
        np.asarray(tridiag_solve_ref(lower, diag, upper, b)))
    with pytest.raises(ValueError, match="route"):
        tridiag_solve(lower, diag, upper, b, "triton")


def _stencil_case(kind, seed):
    """Random coefficients with zeros on land and at closed boundaries,
    and a tracer that is zero on land, on an 18 x 16 plane (288 cells:
    five 64-cell programs per level, the last ragged)."""
    topo = GridTopology(kind, 18, 16, 5)
    rng = np.random.default_rng(seed)
    wet = rng.uniform(size=topo.shape3d) > 0.15
    legs = [np.where(wet, rng.standard_normal(topo.shape3d), 0.0)
            for _ in range(7)]
    coeffs = StencilCoeffs(*[jnp.asarray(a) for a in legs])
    chi = np.where(wet, rng.standard_normal(topo.shape3d), 0.0)
    return topo, coeffs, chi


@pytest.mark.parametrize("transposed", [False, True], ids=["T", "T'"])
@pytest.mark.parametrize("dt", [None, 75.0], ids=["apply", "euler"])
@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("kind", ["bipolar", "tripolar"])
def test_batched_stencil_kernel_matches_apply(monkeypatch, kind, nb, dt,
                                              transposed):
    monkeypatch.setattr(sp, "_TILE", 64)
    topo, coeffs, chi = _stencil_case(kind, seed=nb)
    if transposed:
        coeffs = transpose_coeffs(coeffs, topo)
    chis = jnp.asarray(np.stack([chi * (1 + 0.5 * m) for m in range(nb)]))
    ref = apply_stencil(coeffs, chis, topo)
    if dt is None:
        out = sp.apply_stencil_pallas_multi(coeffs, chis, topo, "interpret")
    else:
        out = sp.euler_step_pallas_multi(coeffs, chis, dt, topo, "interpret")
        ref = chis - dt * ref
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-13, atol=1e-13)


def test_int32_batches_at_the_quarter_degree():
    """A 0.25-degree tracer is 75 * 1080 * 1440 elements: 18 fit int32
    indexing with the stencil's slack, so 19 members go in two calls."""
    item = 75 * 1080 * 1440
    assert pallas_util.int32_batches(8, item, sp._TILE) == [(0, 8)]
    assert pallas_util.int32_batches(19, item, sp._TILE) == [(0, 18), (18, 19)]
    assert pallas_util.int32_batches(40, item, 128) == [(0, 18), (18, 36),
                                                        (36, 40)]
    with pytest.raises(ValueError, match="int32"):
        pallas_util.int32_batches(1, 2**31, 0)


def _spy(monkeypatch, module, name, batch_arg):
    """Record the batch size (positional argument `batch_arg`) of every
    call of `module.name`."""
    calls, inner = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args[batch_arg].shape[0])
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("dt", [None, 75.0], ids=["apply", "euler"])
def test_batched_stencil_splits_past_int32(monkeypatch, dt):
    """With the index limit lowered to two members' worth, a batch of
    five goes in calls of 2, 2 and 1 and equals `apply_stencil`."""
    monkeypatch.setattr(sp, "_TILE", 64)
    topo, coeffs, chi = _stencil_case("tripolar", seed=11)
    monkeypatch.setattr(pallas_util, "INDEX_LIMIT", 2 * chi.size + 64 + 1)
    calls = _spy(monkeypatch, sp, "_stencil_call", 1)
    chis = jnp.asarray(np.stack([chi * (1 + 0.5 * m) for m in range(5)]))
    ref = apply_stencil(coeffs, chis, topo)
    if dt is None:
        out = sp.apply_stencil_pallas_multi(coeffs, chis, topo, "interpret")
    else:
        out = sp.euler_step_pallas_multi(coeffs, chis, dt, topo, "interpret")
        ref = chis - dt * ref
    assert calls == [2, 2, 1]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-13, atol=1e-13)


def test_thomas_kernel_splits_past_int32(monkeypatch):
    shape = (5, 7, 9)
    lower, diag, upper, _ = _tridiag_system(shape, np.float64, seed=12)
    monkeypatch.setattr(pallas_util, "INDEX_LIMIT",
                        2 * int(np.prod(shape)) + tp._COLUMNS + 1)
    calls = _spy(monkeypatch, tp, "_tridiag_call", 3)
    bs = jnp.asarray(np.random.default_rng(13).standard_normal((5,) + shape))
    out = tridiag_solve(lower, diag, upper, bs, "interpret")
    ref = jax.vmap(lambda b: tridiag_solve_ref(lower, diag, upper, b))(bs)
    assert calls == [2, 2, 1]
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


# ---- compiled for the card: skip without a GPU --------------------------


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_thomas_kernel_compiled(gpu, dtype):
    shape = (75, 64, 200)
    lower, diag, upper, _ = _tridiag_system(shape, dtype, seed=7)
    b = jnp.asarray(np.random.default_rng(8).standard_normal(shape), dtype)
    out = tridiag_solve(lower, diag, upper, b, "gpu")
    ref = tridiag_solve_ref(lower, diag, upper, b)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.chip
@pytest.mark.parametrize("kind", ["bipolar", "tripolar"])
def test_batched_stencil_kernel_compiled(gpu, kind):
    topo, coeffs, chi = _stencil_case(kind, seed=9)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), coeffs)
    chis = jnp.asarray(np.stack([chi, 2 * chi, -chi]), jnp.float32)
    out = sp.euler_step_pallas_multi(c32, chis, 50.0, topo, "gpu")
    ref = chis - 50.0 * apply_stencil(c32, chis, topo)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.chip
@pytest.mark.parametrize("kernel", ["stencil", "thomas"])
def test_kernels_split_a_quarter_degree_ensemble_compiled(gpu, kernel):
    """19 members of the 0.25-degree grid pass 2**31 elements, so each
    kernel goes in two calls (18 + 1). Member m is 2**(m % 4) times
    member 0, so each output member must be the single-member output
    times the same power of two."""
    topo = GridTopology("tripolar", 1440, 1080, 75)
    shape = topo.shape3d
    keys = jax.random.split(jax.random.PRNGKey(14), 8)
    uniform = lambda key: jax.random.uniform(key, shape, jnp.float32)
    scale = 2.0 ** (jnp.arange(19) % 4).astype(jnp.float32)
    chis = (jax.random.normal(keys[7], shape, jnp.float32)[None]
            * scale[:, None, None, None])
    if kernel == "stencil":
        coeffs = StencilCoeffs(*[uniform(k) for k in keys[:7]])
        run = lambda x: sp.euler_step_pallas_multi(coeffs, x, 50.0, topo,
                                                   "gpu")
    else:
        lower, upper = -uniform(keys[0]), -uniform(keys[1])
        diag = 2.5 + uniform(keys[2])
        run = lambda x: tridiag_solve(lower, diag, upper, x, "gpu")
    out = run(chis)
    one = run(chis[:1])
    rel = jax.jit(lambda o, r, s: jnp.max(jnp.abs(o - s[:, None, None, None]
                                                  * r)) / jnp.max(jnp.abs(r)))
    assert out.shape == chis.shape
    assert float(rel(out, one, scale)) <= 1e-6
