"""VM exception hierarchy (reference surface:
mythril/laser/ethereum/evm_exceptions.py)."""


class VmException(Exception):
    """The base VM exception."""


class StackUnderflowException(IndexError, VmException):
    """A stack underflow."""


class StackOverflowException(VmException):
    """A stack overflow."""


class InvalidJumpDestination(VmException):
    """An invalid jump destination."""


class InvalidInstruction(VmException):
    """An invalid instruction."""


class OutOfGasException(VmException):
    """An out-of-gas error."""


class WriteProtection(VmException):
    """A write protection error (state mutation inside STATICCALL)."""
