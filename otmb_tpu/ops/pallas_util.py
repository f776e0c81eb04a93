"""The one choice of how the hand-written kernels run.

The kernels (`ops/tridiag_pallas.py`, `ops/stencil_pallas.py`) are
Pallas programs for the Triton route on an NVIDIA GPU. Each entry point
that owns a kernel asks `kernel_route` once and passes the answer down
as a static argument:

  * ``"gpu"`` — the compiled kernel (every `pallas_call` names
    ``backend="triton"``). A kernel that fails to compile raises; there
    is no fallback to the interpreter or to the reference.
  * ``"jnp"`` — the plain `jax.numpy` reference. The CPU has no kernel
    route, so this is what CPU runs take unless a test asks otherwise.
  * ``"interpret"`` — the Pallas interpreter, only when the caller asks
    for it explicitly (CPU tests of the kernels' arithmetic).

No reference counterpart (the reference has no native kernels).
"""

from __future__ import annotations

import jax

ROUTES = ("gpu", "jnp", "interpret")

#: The kernels index their flat operands with int32 (program ids and
#: offsets); a batch whose flat size would reach this is split.
INDEX_LIMIT = 2**31


def kernel_route(interpret: bool = False) -> str:
    """The route for this process's default backend (see module doc).

    Any backend other than the GPU and the CPU is an error: the kernels
    exist for one device family and the plain path for the CPU.
    """
    if interpret:
        return "interpret"
    backend = jax.default_backend()
    if backend == "gpu":
        return "gpu"
    if backend == "cpu":
        return "jnp"
    raise RuntimeError(
        f"no kernel route for backend {backend!r}: the kernels run on "
        "'gpu', the plain jnp path on 'cpu'"
    )


def check_route(route: str) -> str:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}; got {route!r}")
    return route


def int32_batches(nb: int, item: int, slack: int) -> list[tuple[int, int]]:
    """Static [start, stop) slices of a batch of `nb` members of `item`
    elements each, such that a kernel's flat indices over one slice, plus
    `slack` lanes past its end, stay below `INDEX_LIMIT`. One slice when
    the whole batch fits (a 0.25-degree tracer is 1.2e8 elements, so 18
    members fit and an ensemble of 19 or more is split)."""
    per = (INDEX_LIMIT - 1 - slack) // item
    if per < 1:
        raise ValueError(f"one member of {item} elements exceeds int32 "
                         "indexing")
    return [(s, min(s + per, nb)) for s in range(0, nb, per)]
