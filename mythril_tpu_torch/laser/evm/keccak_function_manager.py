"""Symbolic keccak modeling.

Parity surface: mythril/laser/ethereum/keccak_function_manager.py.

Hash applications are uninterpreted-function pairs (keccak256_<bits>,
inverse) constrained VerX-style so a solver can reason about them without
bit-level keccak: the inverse axiom gives injectivity per input; every
input width owns a disjoint 256-bit output interval (so different-width
hashes can never collide); and outputs are 0 mod 64 so consecutive
mapping/array slots spread apart. Concrete inputs are hashed for real
(batched on device by laser/tpu/keccak_tpu.py when many lanes hash at
once) and tied into the same function symbols, so symbolic and concrete
occurrences of one input agree."""

from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.support.keccak import keccak256
from mythril_tpu_torch.smt import (
    And,
    BitVec,
    Bool,
    Function,
    Or,
    ULE,
    ULT,
    URem,
    symbol_factory,
)

# output-interval bookkeeping: the 256-bit space is cut into TOTAL_PARTS
# stripes of width PART; each input bit-length claims one stripe
TOTAL_PARTS = 10 ** 40
PART = (2 ** 256 - 1) // TOTAL_PARTS
INTERVAL_DIFFERENCE = 10 ** 30
SLOT_ALIGNMENT = 64  # hash outputs are pinned to multiples of this

hash_matcher = "fffffff"  # usual prefix for hashes in concretized output

KECCAK_EMPTY = 89477152217924674838424037953991966239322087453347756267410168184682657981552


class KeccakFunctionManager:
    def __init__(self):
        self.store_function: Dict[int, Tuple[Function, Function]] = {}
        self.interval_hook_for_size: Dict[int, int] = {}
        self._index_counter = TOTAL_PARTS - 34534
        self.hash_result_store: Dict[int, List[BitVec]] = {}
        self.quick_inverse: Dict[BitVec, BitVec] = {}  # for concolic runs
        self.concrete_hashes: Dict[BitVec, BitVec] = {}

    def reset(self):
        self.__init__()

    # -- function symbols ----------------------------------------------------

    def get_function(self, length: int) -> Tuple[Function, Function]:
        """The (keccak, inverse) pair for an input bit-length."""
        pair = self.store_function.get(length)
        if pair is None:
            pair = (
                Function("keccak256_{}".format(length), length, 256),
                Function("keccak256_{}-1".format(length), 256, length),
            )
            self.store_function[length] = pair
            self.hash_result_store[length] = []
        return pair

    def _interval_for(self, length: int) -> Tuple[int, int]:
        """[lower, upper) output stripe owned by this input width."""
        index = self.interval_hook_for_size.get(length)
        if index is None:
            index = self._index_counter
            self.interval_hook_for_size[length] = index
            self._index_counter -= INTERVAL_DIFFERENCE
        lower = index * PART
        return lower, lower + PART

    # -- hashing -------------------------------------------------------------

    @staticmethod
    def find_concrete_keccak(data: BitVec) -> BitVec:
        """Hash a concrete input for real."""
        digest = keccak256(data.value.to_bytes(data.size() // 8, byteorder="big"))
        return symbol_factory.BitVecVal(int.from_bytes(digest, "big"), 256)

    @staticmethod
    def get_empty_keccak_hash() -> BitVec:
        return symbol_factory.BitVecVal(KECCAK_EMPTY, 256)

    def create_keccak(self, data: BitVec) -> Tuple[BitVec, Bool]:
        """(hash expression, side condition) for hashing `data`."""
        func, inverse = self.get_function(data.size())

        if data.symbolic is False:
            digest = self.find_concrete_keccak(data)
            self.concrete_hashes[data] = digest
            self.quick_inverse[digest] = data
            return digest, And(
                func(data) == digest, inverse(func(data)) == data
            )

        self.hash_result_store[data.size()].append(func(data))
        return func(data), self._symbolic_conditions(data)

    def _symbolic_conditions(self, data: BitVec) -> Bool:
        """Injectivity + interval + alignment, OR agreement with a concrete
        hash already computed for some input."""
        func, inverse = self.get_function(data.size())
        output = func(data)
        lower, upper = self._interval_for(data.size())
        in_own_stripe = And(
            inverse(output) == data,
            ULE(symbol_factory.BitVecVal(lower, 256), output),
            ULT(output, symbol_factory.BitVecVal(upper, 256)),
            URem(output, symbol_factory.BitVecVal(SLOT_ALIGNMENT, 256)) == 0,
        )
        matches_concrete = symbol_factory.Bool(False)
        for known_input, known_digest in self.concrete_hashes.items():
            matches_concrete = Or(
                matches_concrete,
                And(output == known_digest, known_input == data),
            )
        return And(inverse(output) == data, Or(in_own_stripe, matches_concrete))

    # -- model readback --------------------------------------------------------

    def get_concrete_hash_data(self, model) -> Dict[int, List[Optional[int]]]:
        """Concrete values of every symbolic hash under a model."""
        out: Dict[int, List[Optional[int]]] = {}
        for size, results in self.hash_result_store.items():
            values = []
            for result in results:
                evaluated = model.eval(result.raw, model_completion=False)
                if evaluated is not None and evaluated.value is not None:
                    values.append(evaluated.value)
            out[size] = values
        return out


keccak_function_manager = KeccakFunctionManager()
