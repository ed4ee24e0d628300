"""EVM machine state (the yellow paper's mu): pc, stack, memory, gas.

Parity surface: mythril/laser/ethereum/state/machine_state.py — the
1024-slot stack with int coercion on push, quadratic memory-expansion gas
charged to both bounds of the [min, max] gas interval, and the
concretize-or-skip policy for symbolic memory bounds."""

from copy import copy
from typing import Any, Dict, List, Optional, Union

from mythril_tpu_torch.laser.evm.evm_exceptions import (
    OutOfGasException,
    StackOverflowException,
    StackUnderflowException,
)
from mythril_tpu_torch.laser.evm.state.memory import Memory
from mythril_tpu_torch.support.opcodes import GMEMORY, GQUADRATICMEMDENOM, ceil32
from mythril_tpu_torch.smt import BitVec, Expression, symbol_factory

EVM_STACK_LIMIT = 1024


def _memory_fee(words: int) -> int:
    """Total fee for a memory of `words` 32-byte words (yellow paper C_mem)."""
    return words * GMEMORY + words ** 2 // GQUADRATICMEMDENOM


class MachineState:
    """pc / stack / memory / interval gas accounting for one call frame."""

    def __init__(
        self,
        gas_limit: int,
        pc=0,
        stack=None,
        memory: Optional[Memory] = None,
        constraints=None,
        depth=0,
        max_gas_used=0,
        min_gas_used=0,
        prev_pc=-1,
    ) -> None:
        self._pc = pc
        self.stack = MachineStack(stack)
        self.memory = memory or Memory()
        self.gas_limit = gas_limit
        self.min_gas_used = min_gas_used
        self.max_gas_used = max_gas_used
        self.depth = depth
        self.prev_pc = prev_pc

    # -- plumbing -------------------------------------------------------------

    def __deepcopy__(self, memodict=None):
        return MachineState(
            gas_limit=self.gas_limit,
            max_gas_used=self.max_gas_used,
            min_gas_used=self.min_gas_used,
            pc=self._pc,
            stack=copy(self.stack),
            memory=copy(self.memory),
            depth=self.depth,
            prev_pc=self.prev_pc,
        )

    def __str__(self):
        return str(self.as_dict)

    @property
    def pc(self) -> int:
        return self._pc

    @pc.setter
    def pc(self, value):
        self.prev_pc = self._pc
        self._pc = value

    @property
    def memory_size(self) -> int:
        return len(self.memory)

    @property
    def as_dict(self) -> Dict:
        return dict(
            pc=self._pc,
            stack=self.stack,
            memory=self.memory,
            memsize=self.memory_size,
            gas=self.gas_limit,
            max_gas_used=self.max_gas_used,
            min_gas_used=self.min_gas_used,
            prev_pc=self.prev_pc,
        )

    # -- memory expansion ----------------------------------------------------

    def calculate_extension_size(self, start: int, size: int) -> int:
        """Bytes of extension a [start, start+size) access needs (0 if the
        range already fits)."""
        if self.memory_size > start + size:
            return 0
        new_words = ceil32(start + size) // 32
        current_words = self.memory_size // 32
        return (new_words - current_words) * 32

    def calculate_memory_gas(self, start: int, size: int) -> int:
        """Gas delta of extending to cover [start, start+size)."""
        current_words = self.memory_size // 32
        target_words = ceil32(start + size) // 32
        return _memory_fee(target_words) - _memory_fee(current_words)

    def mem_extend(self, start: Union[int, BitVec], size: Union[int, BitVec]) -> None:
        """Grow memory for an access, charging both gas bounds; symbolic
        bounds are skipped (concretize-or-skip, as in the reference)."""
        if isinstance(start, BitVec):
            if start.symbolic:
                return
            start = start.value
        if isinstance(size, BitVec):
            if size.symbolic:
                return
            size = size.value
        extension = self.calculate_extension_size(start, size)
        if not extension:
            return
        fee = self.calculate_memory_gas(start, size)
        self.min_gas_used += fee
        self.max_gas_used += fee
        self.check_gas()
        self.memory.extend(extension)

    # -- gas -----------------------------------------------------------------

    def check_gas(self) -> None:
        if self.min_gas_used > self.gas_limit:
            raise OutOfGasException()

    # -- stack / memory convenience -------------------------------------------

    def memory_write(self, offset: int, data: List[Union[int, BitVec]]) -> None:
        self.mem_extend(offset, len(data))
        self.memory[offset : offset + len(data)] = data

    def pop(self, amount=1) -> Union[BitVec, List[BitVec]]:
        """Pop `amount` elements, top of stack first."""
        if amount > len(self.stack):
            raise StackUnderflowException
        values = self.stack[-amount:][::-1]
        del self.stack[-amount:]
        return values[0] if amount == 1 else values


class MachineStack(list):
    """EVM operand stack: hard 1024 limit, ints lifted to BitVec on push."""

    STACK_LIMIT = EVM_STACK_LIMIT

    def __init__(self, default_list=None) -> None:
        super().__init__(default_list or [])

    def append(self, element: Union[int, Expression]) -> None:
        if isinstance(element, int):
            element = symbol_factory.BitVecVal(element, 256)
        if len(self) >= EVM_STACK_LIMIT:
            raise StackOverflowException(
                "Reached the EVM stack limit of {}, you can't append more "
                "elements".format(EVM_STACK_LIMIT)
            )
        super().append(element)

    def pop(self, index=-1) -> Union[int, Expression]:
        try:
            return super().pop(index)
        except IndexError:
            raise StackUnderflowException("Trying to pop from an empty stack")

    def __getitem__(self, item: Union[int, slice]) -> Any:
        try:
            return super().__getitem__(item)
        except IndexError:
            raise StackUnderflowException(
                "Trying to access a stack element which doesn't exist"
            )

    def __add__(self, other):
        raise NotImplementedError("Implement this if needed")

    def __iadd__(self, other):
        raise NotImplementedError("Implement this if needed")
