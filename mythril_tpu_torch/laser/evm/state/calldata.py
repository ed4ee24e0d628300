"""Transaction calldata models.

Parity surface: mythril/laser/ethereum/state/calldata.py. Four layouts
behind one interface: concrete bytes over a K-array (solver-friendly),
fully symbolic bytes behind a symbolic size (out-of-bounds reads yield
zero), and "basic" variants of both that trade array theory for If-chains
/ plain lists. Offsets are NATURAL numbers throughout — a read past 2^256
never wraps back into real data (yellow paper reads byte mu_s[0]+i
without modular arithmetic)."""

from typing import Any, List, Union

from mythril_tpu_torch.smt import (
    Array,
    BitVec,
    Concat,
    Expression,
    If,
    K,
    Model,
    UGE,
    ULT,
    simplify,
    symbol_factory,
)

WORD_CEILING = 2 ** 256


def _index_word(item: Union[int, BitVec]) -> BitVec:
    return symbol_factory.BitVecVal(item, 256) if isinstance(item, int) else item


class BaseCalldata:
    """The calldata attached to one transaction."""

    def __init__(self, tx_id: str) -> None:
        self.tx_id = tx_id

    # -- reads ---------------------------------------------------------------

    def get_word_at(self, offset: int) -> Expression:
        """Big-endian 32-byte word at `offset`."""
        return simplify(Concat(self[offset : offset + 32]))

    def __getitem__(self, item: Union[int, slice, BitVec]) -> Any:
        if isinstance(item, (int, Expression)):
            return self._load(item)
        if isinstance(item, slice):
            return self._load_slice(item)
        raise ValueError

    def _load_slice(self, window: slice) -> List[Expression]:
        start = 0 if window.start is None else window.start
        step = 1 if window.step is None else window.step
        stop = self.size if window.stop is None else window.stop

        if all(isinstance(v, int) for v in (start, stop, step)):
            # concrete window: indexes past 2^256 read zero (no wraparound)
            parts = []
            for index in range(start, stop, step):
                if len(parts) >= 0x1000:
                    raise IndexError("Invalid Calldata Slice")
                if index >= WORD_CEILING:
                    cell: Any = symbol_factory.BitVecVal(0, 8)
                else:
                    cell = self._load(index)
                if not isinstance(cell, Expression):
                    cell = symbol_factory.BitVecVal(cell, 8)
                parts.append(cell)
            return parts

        # symbolic window: walk until the index term closes on the stop term
        cursor = _index_word(start)
        stop_word = stop if isinstance(stop, BitVec) else _index_word(stop)
        parts = []
        while True:
            at_end = cursor != stop_word
            if at_end.value is False:
                break
            if len(parts) >= 0x1000:
                raise IndexError("Invalid Calldata Slice")
            cell = self._load(cursor)
            if not isinstance(cell, Expression):
                cell = symbol_factory.BitVecVal(cell, 8)
            parts.append(cell)
            cursor = simplify(cursor + step)
        return parts

    # -- subclass surface -----------------------------------------------------

    @property
    def calldatasize(self) -> BitVec:
        result = self.size
        if isinstance(result, int):
            return symbol_factory.BitVecVal(result, 256)
        return result

    def _load(self, item: Union[int, BitVec]) -> Any:
        raise NotImplementedError()

    @property
    def size(self) -> Union[BitVec, int]:
        """The exact (unnormalized) size of this calldata."""
        raise NotImplementedError()

    def concrete(self, model: Model) -> list:
        """Concrete bytes under the given model."""
        raise NotImplementedError


class SymbolicCalldata(BaseCalldata):
    """Unconstrained byte Array behind a symbolic size; reads past the size
    yield zero."""

    def __init__(self, tx_id: str) -> None:
        self._size = symbol_factory.BitVecSym(str(tx_id) + "_calldatasize", 256)
        self._calldata = Array("{}_calldata".format(tx_id), 256, 8)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> Any:
        index = _index_word(item)
        return simplify(
            If(
                ULT(index, self._size),
                simplify(self._calldata[index]),
                symbol_factory.BitVecVal(0, 8),
            )
        )

    def concrete(self, model: Model) -> list:
        length = model.eval(self.size.raw, model_completion=True).value
        return [
            model.eval(self._load(i).raw, model_completion=True).value
            for i in range(length)
        ]

    @property
    def size(self) -> BitVec:
        return self._size


class BasicSymbolicCalldata(BaseCalldata):
    """Symbolic bytes without array theory: reads are recorded as (index,
    fresh symbol) pairs and concretized through the model."""

    def __init__(self, tx_id: str) -> None:
        self._reads: List = []
        self._size = symbol_factory.BitVecSym(str(tx_id) + "_calldatasize", 256)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec], clean=False) -> Any:
        expr_item = _index_word(item)
        symbolic_base_value = If(
            UGE(expr_item, self._size),
            symbol_factory.BitVecVal(0, 8),
            symbol_factory.BitVecSym(
                "{}_calldata_{}".format(self.tx_id, str(item)), 8
            ),
        )
        return_value = symbolic_base_value
        for stored_item, stored_value in self._reads:
            return_value = If(stored_item == expr_item, stored_value, return_value)
        if not clean:
            self._reads.append((expr_item, symbolic_base_value))
        return simplify(return_value)

    def concrete(self, model: Model) -> list:
        length = model.eval(self.size.raw, model_completion=True).value
        return [
            model.eval(self._load(i, clean=True).raw, model_completion=True).value
            for i in range(length)
        ]

    @property
    def size(self) -> BitVec:
        return self._size

class ConcreteCalldata(BaseCalldata):
    """Known bytes over a K-array (so symbolic indexes stay array terms)."""

    def __init__(self, tx_id: str, calldata: list) -> None:
        self._concrete_calldata = calldata
        self._calldata = K(256, 8, 0)
        for position, byte in enumerate(calldata):
            if isinstance(byte, int):
                byte = symbol_factory.BitVecVal(byte, 8)
            self._calldata[symbol_factory.BitVecVal(position, 256)] = byte
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> BitVec:
        return simplify(self._calldata[_index_word(item)])

    def concrete(self, model: Model) -> list:
        return self._concrete_calldata

    @property
    def size(self) -> int:
        return len(self._concrete_calldata)


class BasicConcreteCalldata(BaseCalldata):
    """Known bytes without array theory: symbolic reads become If-chains."""

    def __init__(self, tx_id: str, calldata: list) -> None:
        self._calldata = calldata
        super().__init__(tx_id)

    def _load(self, item: Union[int, Expression]) -> Any:
        if isinstance(item, int):
            try:
                return self._calldata[item]
            except IndexError:
                return 0
        value = symbol_factory.BitVecVal(0, 8)
        for position in range(self.size):
            value = If(item == position, self._calldata[position], value)
        return value

    def concrete(self, model: Model) -> list:
        return self._calldata

    @property
    def size(self) -> int:
        return len(self._calldata)
