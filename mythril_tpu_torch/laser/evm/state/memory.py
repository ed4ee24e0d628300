"""Contract memory (reference surface: mythril/laser/ethereum/state/memory.py).

Byte cells keyed by concrete int offsets with a structural-key overlay for
symbolic offsets (matching the reference's dict-of-BitVec model: symbolic
reads/writes resolve by structural equality of the index expression, not by
may-alias reasoning). Word access packs/unpacks via Concat/Extract with a
concrete fast path."""

from copy import copy
from typing import Dict, List, Union

from mythril_tpu_torch.laser.evm import util
from mythril_tpu_torch.smt import BitVec, Bool, Concat, Extract, If, simplify, symbol_factory

# iterations to perform when a slice bound is symbolic
APPROX_ITR = 100


def convert_bv(val: Union[int, BitVec]) -> BitVec:
    if isinstance(val, BitVec):
        return val
    return symbol_factory.BitVecVal(val, 256)


def _key(index: Union[int, BitVec]):
    """Canonical dict key for a memory index: int when concrete, the
    hash-consed term otherwise."""
    if isinstance(index, int):
        return index
    if index.value is not None:
        return index.value
    return index.raw


class Memory:
    """Contract memory with random access."""

    def __init__(self):
        self._msize = 0
        self._memory: Dict = {}

    def __len__(self):
        return self._msize

    def __copy__(self):
        new_memory = Memory()
        new_memory._memory = copy(self._memory)
        new_memory._msize = self._msize
        return new_memory

    def extend(self, size: int):
        self._msize += size

    def get_word_at(self, index: Union[int, BitVec]) -> Union[int, BitVec]:
        """Read a 32-byte big-endian word."""
        parts = self[index : index + 32 if isinstance(index, int) else convert_bv(index) + 32]
        try:
            concrete_bytes = bytes([util.get_concrete_int(b) for b in parts])
            return symbol_factory.BitVecVal(int.from_bytes(concrete_bytes, "big"), 256)
        except TypeError:
            result = simplify(
                Concat(
                    [
                        b if isinstance(b, BitVec) else symbol_factory.BitVecVal(b, 8)
                        for b in parts
                    ]
                )
            )
            assert result.size() == 256
            return result

    def write_word_at(self, index: Union[int, BitVec], value: Union[int, BitVec, bool, Bool]) -> None:
        """Write a 32-byte big-endian word."""
        try:
            if isinstance(value, bool):
                _bytes = int(value).to_bytes(32, byteorder="big")
            else:
                _bytes = util.concrete_int_to_bytes(value)
            self[index : (index + 32 if isinstance(index, int) else convert_bv(index) + 32)] = list(
                bytearray(_bytes)
            )
        except TypeError:
            if isinstance(value, Bool):
                value_to_write = If(
                    value,
                    symbol_factory.BitVecVal(1, 256),
                    symbol_factory.BitVecVal(0, 256),
                )
            else:
                value_to_write = value
            assert value_to_write.size() == 256
            for i in range(0, value_to_write.size(), 8):
                byte_index = index + 31 - (i // 8) if isinstance(index, int) else convert_bv(index) + (31 - i // 8)
                self[byte_index] = Extract(i + 7, i, value_to_write)

    def _slice_bounds(self, item: slice):
        start = 0 if item.start is None else item.start
        if item.stop is None:
            raise IndexError("Invalid Memory Slice")
        step = 1 if item.step is None else item.step
        return start, item.stop, step

    def __getitem__(self, item: Union[int, BitVec, slice]) -> Union[BitVec, int, List]:
        if isinstance(item, slice):
            start, stop, step = self._slice_bounds(item)
            bvstart, bvstop = convert_bv(start), convert_bv(stop)
            ret_lis = []
            if bvstart.value is not None and bvstop.value is not None:
                for i in range(bvstart.value, bvstop.value, step):
                    ret_lis.append(self[i])
            else:
                # symbolic bound: approximate with a bounded unroll
                current = bvstart
                for _ in range(APPROX_ITR):
                    if (current == bvstop).value is True:
                        break
                    ret_lis.append(self[current])
                    current = simplify(current + step)
            return ret_lis
        return self._memory.get(_key(item), 0)

    def __setitem__(self, key: Union[int, BitVec, slice], value) -> None:
        if isinstance(key, slice):
            start, stop, step = self._slice_bounds(key)
            if step != 1:
                raise AssertionError("step size must be 1 for memory slices")
            assert type(value) == list
            bvstart, bvstop = convert_bv(start), convert_bv(stop)
            if bvstart.value is not None and bvstop.value is not None:
                for n, i in enumerate(range(bvstart.value, bvstop.value)):
                    self[i] = value[n]
            else:
                current = bvstart
                for n in range(min(APPROX_ITR, len(value))):
                    if (current == bvstop).value is True:
                        break
                    self[current] = value[n]
                    current = simplify(current + 1)
            return
        k = _key(key)
        if isinstance(k, int) and k >= self._msize:
            return
        if isinstance(value, int):
            assert 0 <= value <= 0xFF
        if isinstance(value, BitVec):
            assert value.size() == 8
        self._memory[k] = value
