"""Top-level exceptions (reference surface: mythril/exceptions.py)."""


class MythrilTpuBaseException(Exception):
    """Base class for exceptions in this framework."""


class CompilerError(MythrilTpuBaseException):
    """Compilation of a contract failed."""


class UnsatError(MythrilTpuBaseException):
    """A constraint set was proven (or assumed after timeout) unsatisfiable."""


class NoContractFoundError(MythrilTpuBaseException):
    """No contract was found in the given source."""


class CriticalError(MythrilTpuBaseException):
    """A critical, user-facing error."""


class AddressNotFoundError(MythrilTpuBaseException):
    """The address was not found."""


class DetectorNotFoundError(MythrilTpuBaseException):
    """A requested detection module was not found."""
