"""On-demand compilation and loading of the native helpers via ctypes.

Build artifacts are cached in `_build/` beside the sources (listed in
.gitignore), keyed by a content hash, so a source change triggers a
rebuild and stale .so files are never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_HERE, "_build")
_CACHE: dict[str, ctypes.CDLL | None] = {}


def load_library(name: str) -> ctypes.CDLL | None:
    """Compile (if needed) and load `<name>.cpp` from this directory.

    Returns None when no working C++ toolchain is available — callers fall
    back to their Python implementation.
    """
    if name in _CACHE:
        return _CACHE[name]

    src = os.path.join(_HERE, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD, f"_{name}_{digest}.so")

    if not os.path.exists(out):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = tempfile.mktemp(suffix=".so", dir=_BUILD)
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)  # atomic under concurrent builds
        except (subprocess.SubprocessError, OSError) as e:
            logger.warning("native build of %s failed (%s); using Python "
                           "fallback", name, e)
            _CACHE[name] = None
            return None

    try:
        lib = ctypes.CDLL(out)
    except OSError as e:  # pragma: no cover
        logger.warning("loading %s failed (%s); using Python fallback", out, e)
        lib = None
    _CACHE[name] = lib
    return lib
