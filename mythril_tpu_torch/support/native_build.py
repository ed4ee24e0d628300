"""Build/load the native C++ engine (keccak + CDCL SAT) via ctypes.

The shared library is compiled on first use with g++ (no pybind11 — plain C
ABI) and cached under mythril_tpu_torch/_build/. If no compiler is available the
callers fall back to the pure-Python implementations.
"""

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

log = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO = os.path.join(_BUILD_DIR, "_mythril_native.so")


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    return os.path.getmtime(_SRC) > os.path.getmtime(_SO)


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = ["g++", "-O3", "-std=c++14", "-shared", "-fPIC", "-o", _SO + ".tmp", _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(_SO + ".tmp", _SO)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native build failed (%s); using pure-python fallbacks", e)
        return False


def load_native_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if _needs_build() and not _build():
                return None
            _lib = ctypes.CDLL(_SO)
        except OSError as e:
            log.warning("could not load native lib: %s", e)
            _lib = None
        return _lib
