"""ctypes wrapper exposing the C++ CDCL solver with the PySat interface.

Clause and variable creation are buffered host-side and shipped to the
native engine in bulk (tsat_add_clauses / tsat_ensure_vars) right before a
solve: per-call ctypes marshalling used to dominate bit-blasting time by
~25x, so the wrapper batches the API instead.
"""

import ctypes
from array import array
from typing import Iterable, List, Optional

from mythril_tpu_torch.smt.solver import pysat
from mythril_tpu_torch.support.native_build import load_native_lib

SAT = pysat.SAT
UNSAT = pysat.UNSAT
UNKNOWN = pysat.UNKNOWN

_configured = False


def _lib():
    global _configured
    lib = load_native_lib()
    if lib is not None and not _configured:
        lib.tsat_new.restype = ctypes.c_void_p
        lib.tsat_free.argtypes = [ctypes.c_void_p]
        lib.tsat_new_var.argtypes = [ctypes.c_void_p]
        lib.tsat_new_var.restype = ctypes.c_int
        lib.tsat_add_clause.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.tsat_add_clauses.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.tsat_ensure_vars.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tsat_solve.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_longlong,
        ]
        lib.tsat_solve.restype = ctypes.c_int
        lib.tsat_model_value.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tsat_model_value.restype = ctypes.c_int
        lib.tsat_model_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_byte),
            ctypes.c_int,
        ]
        lib.tsat_ok.argtypes = [ctypes.c_void_p]
        lib.tsat_ok.restype = ctypes.c_int
        lib.tsat_interrupt.argtypes = [ctypes.c_void_p]
        lib.tsat_clear_interrupt.argtypes = [ctypes.c_void_p]
        lib.tsat_set_phase.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        _configured = True
    return lib


class NativeSat:
    """Same interface as pysat.PySat, backed by csrc/native.cpp."""

    def __init__(self) -> None:
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native solver unavailable")
        self._s = self._lib.tsat_new()
        self._nvars = 0
        self._synced_vars = 0
        self._pending = array("i")  # flat clause buffer, 0-separated
        self.n_clauses = 0

    def __del__(self):
        try:
            if getattr(self, "_s", None):
                self._lib.tsat_free(self._s)
                self._s = None
        except Exception:  # noqa - __del__ during interpreter teardown must never raise
            pass

    def new_var(self) -> int:
        self._nvars += 1
        return self._nvars

    def add_clause(self, lits: Iterable[int]) -> None:
        self._pending.extend(lits)
        self._pending.append(0)
        self.n_clauses += 1

    def _flush(self) -> None:
        if self._nvars > self._synced_vars:
            self._lib.tsat_ensure_vars(self._s, self._nvars)
            self._synced_vars = self._nvars
        if self._pending:
            buf = (ctypes.c_int * len(self._pending)).from_buffer(self._pending)
            self._lib.tsat_add_clauses(self._s, buf, len(self._pending))
            del buf
            self._pending = array("i")

    def solve(
        self,
        assumptions: Optional[List[int]] = None,
        timeout_ms: Optional[int] = None,
        conflict_budget: Optional[int] = None,
    ) -> int:
        self._flush()
        arr = list(assumptions or [])
        buf = (ctypes.c_int * len(arr))(*arr)
        return self._lib.tsat_solve(
            self._s, buf, len(arr), timeout_ms or 0, conflict_budget or 0
        )

    def model_value(self, var: int) -> int:
        if var > self._synced_vars:
            return -1
        return self._lib.tsat_model_value(self._s, var)

    def model_copy(self) -> array:
        """Whole assignment as a 1-based array (index 0 unused): 1/-1/0."""
        buf = (ctypes.c_byte * self._synced_vars)()
        self._lib.tsat_model_copy(self._s, buf, self._synced_vars)
        # frombytes on the ctypes buffer is one memcpy; building
        # array("b", buf) element-wise iterated a ~1M-entry ctypes array
        # per query and dominated the host engine's profile
        out = array("b", b"\x00")
        out.frombytes(buf)
        return out

    def interrupt(self) -> None:
        """Cooperatively cancel a solve running in another thread; it
        returns UNKNOWN at its next poll point (per conflict / per 1024
        decisions)."""
        self._lib.tsat_interrupt(self._s)

    def clear_interrupt(self) -> None:
        self._lib.tsat_clear_interrupt(self._s)

    def set_phase(self, var: int, sign: int) -> None:
        """Seed the saved decision phase of ``var`` (e.g. from a device
        model) so the next descent tries that polarity first."""
        self._lib.tsat_set_phase(self._s, var, sign)

    @property
    def ok(self) -> bool:
        self._flush()
        return bool(self._lib.tsat_ok(self._s))


def make_sat():
    """Preferred SAT engine: native C++, falling back to pure Python."""
    try:
        return NativeSat()
    except (RuntimeError, OSError):
        return pysat.PySat()
